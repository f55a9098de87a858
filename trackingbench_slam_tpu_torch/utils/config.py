"""Single dataclass config tree for the whole pipeline.

A copy of trackingbench_slam_tpu/utils/config.py: the two packages read the
same configurations, field for field.

The reference has no config system at all — every parameter is a hardcoded
literal at a call site (intrinsics inline at test/test_vo.cpp:176,633; optimizer
intrinsics baked into src/mapping/LocalBA.cpp:356-359; extraction params at
test/test_vo.cpp:194-200). Here everything is one serializable config tree so a
run is reproducible from its config alone.

All counts are *static capacities*: TPU programs are traced once, so variable
feature/match/landmark counts become fixed-size arrays plus validity masks.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera with radial-tangential distortion.

    Mirrors the capability of the reference PinholeCamera
    (include/camera/CameraModel.h:9-89): fx, fy, cx, cy plus (k1,k2,p1,p2,k3).
    """

    width: int = 640
    height: int = 480
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # stereo baseline * fx ("bf"), as used for depth = bf / disparity
    # (reference: src/mapping/LocalBA.cpp:65)
    bf: float = 0.0


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Image pyramid. Reference builds 5 levels at scale 0.8 for direct
    tracking (src/types/Frame.cpp:414-451) and 8 levels at 1/1.2 for ORB."""

    num_levels: int = 5
    scale_factor: float = 0.8  # per-level multiplier, < 1


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """FAST/ORB extraction operating point.

    Reference operating point: 2000 features, thresholds 80 -> 30 fallback,
    grid-cell distribution (test/test_vo.cpp:194-200, src/extractors/).
    The data-dependent octree of ORBextractor.cpp:494-733 is replaced with
    per-cell top-k by response — same spatial-uniformity intent, static shapes
    (this is the strategy the reference's own FASTextractor uses,
    src/extractors/FASTextractor.cpp:18-25).
    """

    num_features: int = 2000
    # Two-threshold fallback (ORBextractor.cpp:765-804): cells holding a
    # corner that survives detection at init_threshold drop their weaker
    # (>= min_threshold only) corners; cells with none keep the weak ones.
    # <= min_threshold disables the second pass (the DEFAULT): on smooth
    # synthetic renders the gate starves re-acquisition after a low-inlier
    # stretch (measured on the loop bench: a transient 12-inlier dip that
    # ungated extraction recovers from became a permanent teleport with the
    # gate at 24 or 40). On real imagery the reference runs iniTh/minTh =
    # 80/30 ~ 2.7x; set init_threshold ~ 2.7 * min_threshold for parity.
    init_threshold: int = 0
    min_threshold: int = 7
    cell_size: int = 32  # occupancy-grid cell in pixels at level 0
    patch_half: int = 15  # ORB orientation/descriptor patch half size (31x31)
    descriptor_bits: int = 256
    fast_arc: int = 9  # FAST-N contiguous-arc length (9 or 10)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Shared matcher tunables. Reference: include/matchers/matcher.h:23-27
    (TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30, ratio, orientation check)."""

    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    nn_ratio: float = 0.9
    # NN/BF global-min accept rule: dist < min(min_dist_ratio * global_min,
    # min_dist_cap) — reference call sites pass ratio=10, minTh=30
    # (test/test_vo.cpp:213, test/test_matcher.cpp:68)
    min_dist_ratio: float = 10.0
    min_dist_cap: float = 30.0
    check_orientation: bool = True
    search_radius: float = 15.0  # windowed search radius in px at level 0
    max_matches: int = 2048  # static capacity of a match set
    # CLAHE-equalize both pyramids before frame-to-frame LK tracking
    # (Frame::Equalize applied by searchByOPFlow, Frame.cpp:453-458 /
    # matcher.cpp:737-742) — stabilizes tracking under exposure flicker /
    # vignetting at the cost of one histogram pass per pyramid level
    equalize: bool = False


@dataclasses.dataclass(frozen=True)
class DirectConfig:
    """SVO-style direct alignment params (matcher.h:112-119 setDirectParam +
    hardcoded constants in matcher.cpp)."""

    patch_half: int = 2  # 4x4 patch for sparse image align (matcher.cpp:893)
    align_patch_half: int = 4  # 8x8 patch for Align2D (matcher.cpp:1552)
    max_level: int = 4
    min_level: int = 0
    align_iters: int = 20
    sparse_iters: int = 10
    conv_eps: float = 0.03  # Align2D convergence ||dx|| (matcher.cpp:1468)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pose / BA solver operating point. Reference: 4 rounds x 10 LM iters,
    chi2 gate 5.991, Huber delta sqrt(5.991), lambda0 1e-4
    (src/mapping/LocalBA.cpp:291-490)."""

    rounds: int = 4
    iters_per_round: int = 10
    chi2_threshold: float = 5.991
    huber_delta: float = 2.4477  # sqrt(5.991)
    init_lambda: float = 1e-4
    # windowed BA: number of NEWEST ring keyframes whose poses optimize in a
    # local-BA pass; all older ring poses enter as fixed vertices (their
    # observations still constrain landmarks — ORB-SLAM's lFixedCameras).
    # Full-ring optimization re-fits old poses to long-drifted LK
    # observations and measurably degrades keyframe accuracy (diag r3).
    window_keyframes: int = 5
    max_landmarks: int = 4096
    # Stereo u_R rows in windowed BA. The u_R observation comes from stereo
    # LK; measured against GT geometry its error is UNBIASED but heavy-
    # tailed (|err| mean ~0.6 px, std ~1.2 px vs ~0.2 px for the anchored
    # left-image observations — tools/diag_ba_gap.py). The per-observation
    # Huber cannot isolate a bad row (it scales all three rows together),
    # so: (a) stereo_gate_px drops u_R rows whose residual at the CURRENT
    # window estimate exceeds the gate (the estimate is mm-accurate, so
    # the gate kills tails, not signal; 0 disables), and (b) stereo_weight
    # can down-weight the survivors. Measured on the bench corridor: the
    # gate alone recovers BA-beats-motion-only (ATE 0.25 vs 0.29 cm) at
    # full row weight; without it BA was WORSE than tracking (0.33 cm).
    stereo_weight: float = 1.0
    stereo_gate_px: float = 1.5
    # LM iterations per live local-BA pass: the grouped solver converges in
    # a handful of accepted steps; 6 keeps the per-keyframe cost ~80 ms
    ba_iters: int = 6


@dataclasses.dataclass(frozen=True)
class BowConfig:
    """Vocabulary shape. Reference DBoW2 uses k-branching, L-level trees
    (third_part/DBoW2/DBoW2/TemplatedVocabulary.h:44); ORBvoc is k=10, L=6.
    We train smaller vocabularies from dataset descriptors."""

    branching: int = 8
    levels: int = 4
    levels_up: int = 2  # FeatureVector node granularity (ref levelsup=4 of L=6)
    kmedians_iters: int = 8


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map store (replaces std::set Map, src/types/Map.cpp)."""

    max_keyframes: int = 32
    max_points: int = 16384
    max_obs_per_point: int = 16
    max_candidates: int = 4096


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes for distributed BA: landmarks sharded over 'lm',
    feature batch over 'dp'. See parallel/."""

    dp: int = 1
    lm: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = CameraConfig()
    pyramid: PyramidConfig = PyramidConfig()
    extractor: ExtractorConfig = ExtractorConfig()
    matcher: MatcherConfig = MatcherConfig()
    direct: DirectConfig = DirectConfig()
    solver: SolverConfig = SolverConfig()
    bow: BowConfig = BowConfig()
    map: MapConfig = MapConfig()
    mesh: MeshConfig = MeshConfig()
    keyframe_every: int = 10  # reference inserts a KF every 10 frames (test_vo.cpp:772)
    # run windowed local BA (models/local_mapping.py) after every N-th
    # keyframe insertion; 0 disables the stage (motion-only tracking, the
    # reference's live behavior)
    local_ba_every: int = 2
    # pyramid levels for frame-to-frame LK. With the constant-velocity flow
    # prior carried in VOState, 2 half-scale levels cover ~+-24 px of
    # residual motion at full res; each extra level costs ~2 us/point of
    # template setup on TPU. Set to 0 to use the full LK pyramid (the
    # reference's cv::calcOpticalFlowPyrLK maxLevel=3 behavior) and no prior.
    lk_track_levels: int = 2
    dtype: str = "float32"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        """The config `to_json` wrote (or the reference's to_json); keys
        this package does not know are skipped, as the reference skips
        them."""
        def build(klass, sub):
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                kwargs[k] = (build(fields[k].default.__class__, v)
                             if isinstance(v, dict) else v)
            return klass(**kwargs)
        return build(cls, json.loads(s))


def kitti_stereo_config() -> PipelineConfig:
    """KITTI odometry gray operating point (reference test_kitti,
    test/test_vo.cpp:613-872: fx=fy=718.856 cx=607.19 cy=185.22,
    bf=0.573*718.856)."""
    cam = CameraConfig(
        width=1241, height=376,
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        bf=0.573 * 718.856,
    )
    return PipelineConfig(camera=cam)


def euroc_stereo_config() -> PipelineConfig:
    """EuRoC MH operating point (reference test_vo_1, test/test_vo.cpp:
    109-296), where the indirect tracker runs."""
    cam = CameraConfig(
        width=752, height=480,
        fx=435.2046959714599, fy=435.2046959714599,
        cx=367.4517211914062, cy=252.2008514404297,
        bf=47.90639384423901,
    )
    return PipelineConfig(camera=cam)
