"""SLAM filter configuration.

Re-design of the reference's config system
(/root/reference/src/main.cpp:956-1073 ``loadConfig`` and
/root/reference/src/slamtypes.h:142-250 ``SlamConfig``).

Differences from the reference (deliberate, see SURVEY.md §7.3):

* The reference maps ``initial_vz``/``initial_vroll``/``initial_vpitch`` onto the
  wrong struct fields (main.cpp:970-972); here they map to the right ones.
* Capacity limits (``max_features``/K_max, ``max_measurements``/M_max) are
  enforced: they size the fixed-capacity device arrays that replace the
  reference's ragged per-particle ``std::vector`` maps.
* ``clutterDensity`` is derived exactly as in the reference:
  ``clutter_rate / (2 * max_bearing * max_range)`` (main.cpp:1064-1066).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional


@dataclasses.dataclass
class SlamConfig:
    # -- debug
    debug: bool = False

    # -- initial vehicle state (main.cpp:958-969)
    x0: float = 0.0
    y0: float = 0.0
    z0: float = 0.0
    roll0: float = 0.0
    pitch0: float = 0.0
    yaw0: float = 0.0
    vx0: float = 0.0
    vy0: float = 0.0
    vz0: float = 0.0
    vroll0: float = 0.0
    vpitch0: float = 0.0
    vyaw0: float = 0.0

    follow_trajectory: bool = False
    motion_type: int = 1  # 0 = constant velocity, 1 = Ackerman steering

    # -- vehicle CV process noise (std of accelerations)
    ax: float = 0.5
    ay: float = 0.0
    az: float = 0.0
    aroll: float = 0.0087
    apitch: float = 0.0087
    ayaw: float = 0.0087

    dt: float = 0.1

    # -- range-bearing sensor
    max_bearing: float = math.pi
    min_range: float = 0.0
    max_range: float = 20.0
    std_bearing: float = 0.0524
    std_range: float = 1.0
    clutter_rate: float = 15.0
    pd: float = 0.98

    # -- feature survival / motion
    ps: float = 0.98
    std_vx_map: float = 0.0   # constant-position model process noise
    std_vy_map: float = 0.0
    std_ax_map: float = 0.0   # constant-velocity feature model process noise
    std_ay_map: float = 0.0
    cov_vx_birth: float = 0.0
    cov_vy_birth: float = 0.0

    # -- jump-markov (mixed model) params
    tau: float = 0.0
    beta: float = 1.0

    # -- particle filter
    n_particles: int = 512
    n_predict_particles: int = 1
    subdivide_predict: int = 1
    resample_threshold: float = 0.15

    # -- PHD parameters
    birth_weight: float = 0.05
    birth_noise_factor: float = 1.5
    # Gated births (CPHD path, phdfilter.cu.bak:794-900 + compatibleZ
    # :1567, :1695): births only from measurements with no existing
    # in-range feature within gate_threshold measurement-space Mahalanobis
    # distance; the birth cardinality binomial uses the per-particle gated
    # count. Default OFF = the reference's effective live behavior (its
    # gatedBirths field is undefined in the final slamtypes.h, so the
    # gate never engaged; the .bak kernel hardcodes threshold 5).
    gate_births: bool = False
    gate_measurements: bool = True    # parsed but unused in reference too
    gate_threshold: float = 5.0       # .bak:1694 hardcodes 5
    feature_model: int = 0            # 0 static / 1 dynamic / 2 mixed
    min_expected_feature_weight: float = 0.33
    min_separation: float = 5.0
    max_features: int = 100
    min_feature_weight: float = 1e-5
    # 0 cluster-process, 1 Vo empty-map, 2 single-feature RB.
    # Scheme 2 runs on the two-stage selection fast pipeline
    # (argmax single-object likelihood over the selected top-T lanes +
    # two GM point evaluations, phdfilter.cu:3599-3661); it only differs
    # from the reference's full-grid search when the argmax hides in a
    # sub-top-T / sub-threshold pdw lane. The MC variance estimator
    # (compute_variance) likewise runs on the selected lanes for D=2
    # fast-path configs (extras.mc_variance_packed); only non-2D /
    # cap-disabled configs fall back to the full-grid slow path. Schemes
    # 0/1 are the benchmark path. (Scheme 2 scores ~50 m on
    # multi-landmark datasets — inherent to the scheme, see
    # .claude/skills/verify.)
    particle_weighting: int = 1
    # DEAD in the reference: parsed into SlamConfig (main.cpp:1006,
    # slamtypes.h:225) but never read by any kernel or host code in
    # phdfilter.cu, phdfilter.cu.bak or the CPU sources — the "1: Particle"
    # daughter representation was never implemented. Parsed here for
    # config-file compatibility only.
    daughter_mixture_type: int = 0
    n_samples: int = 50               # MC samples for the variance estimator
    max_cardinality: int = 256
    filter_type: int = 1              # 0 = PHD, 1 = CPHD
    map_estimate: int = 1             # bit 0 = MAP, bit 1 = EAP
    # DEAD in the reference: cphd_disttype ("0 = Binomial Poisson,
    # 1 = COM-Poisson", main.cpp:1011-1012, slamtypes.h:235-236) and its
    # nu parameter are parsed and never read — the COM-Poisson clutter
    # cardinality was never implemented; the live clutter cardinality is
    # always the Poisson pmf (cphdConstantsKernel, .bak:369-415, matched
    # by cphd_constants). Parsed here for config-file compatibility only.
    cphd_dist_type: int = 0
    nu: float = 1.0
    distance_metric: int = 0          # 0 = Mahalanobis, 1 = Hellinger
    labeled_measurements: bool = False

    # -- Ackerman vehicle geometry
    h: float = 0.0
    l: float = 0.0
    a: float = 0.0
    b: float = 0.0
    std_encoder: float = 0.0
    std_alpha: float = 0.0

    # -- camera / disparity (SC-PHD) pipeline
    std_u: float = 1.0
    std_v: float = 1.0
    disparity_birth: float = 1000.0
    image_width: int = 600
    image_height: int = 480
    std_d_birth: float = 300.0
    fx: float = 1000.0
    fy: float = 1000.0
    u0: float = 512.0
    v0: float = 384.0
    particles_per_feature: int = 100
    # Disparity floor for re-sampled feature clouds. The reference samples
    # merged (u,v,d) Gaussians and maps them through the 1/d singularity
    # unguarded (sampleGaussiansKernel + disparity_to_world,
    # phdfilter.cu:4250-4304, 4024-4047): with the wide birth prior
    # (std_d_birth ~ disparity_birth) several percent of samples land at
    # d <= 0, i.e. BEHIND the camera, and the poisoned cloud's next fit is
    # a ghost feature (SURVEY.md §7.3 do-not-replicate). REFLECTING samples
    # off this positive floor (max depth fx/min_disparity) removes the
    # ghosts; clamping instead piles mass at the floor, whose depth
    # leverage is just as destructive (filters/disparity.py).
    min_disparity: float = 0.5

    # -- run control
    data_directory: str = "data/"
    max_time_steps: int = 10000
    save_all_maps: bool = False
    save_prediction: bool = False
    n_steps: int = -1

    # -- additions (fixed-capacity array sizing; no reference counterpart:
    #    the reference uses ragged vectors + thrust compaction)
    max_measurements: int = 64        # M_max: measurements per scan (ref clamps at 256, phdfilter.cu:3389-3394)
    dtype: str = "float32"
    seed: int = 0
    # MC map-variance estimator (phdVarianceKernel): the reference runs it
    # unconditionally on the static path; here it is opt-in (diagnostic only)
    compute_variance: bool = False
    # Greedy-merge kernel (ops/pallas_merge.py): 0 = off (the XLA
    # while_loop reference), 1 = auto (the Pallas kernel on a CUDA GPU, XLA
    # elsewhere), 2 = the kernel in interpret mode (CPU testing)
    pallas_merge: int = 1
    # Merge-candidate compaction: the update produces K*(M+1)+M candidates
    # (phdfilter.cu:3078) but only a few hundred carry weight above
    # min_feature_weight. top-k-compact to this many lanes before the greedy
    # merge loop (0 = disabled). Drops only the lowest-weight tail and
    # reports drops via the overflow counter.
    merge_candidate_cap: int = 512
    # Two-stage candidate selection: per measurement, keep the heaviest T
    # live detection lanes before the global top-cap pass (0 = disabled).
    # The full live set whenever a measurement has <= T live lanes; drops
    # are counted into the overflow diagnostic.
    # Cuts the global selection from K*(M+1)+M lanes to K+M*T+M. Raise for
    # dense worlds where single measurements gate many features.
    detection_topk: int = 16
    # Merge kernel: clusters extracted per loop trip (R-way exact greedy;
    # see ops/pallas_merge.py). Changes the trip count, not the result;
    # 4 was fastest of 4/8/16 on the H100.
    merge_r_par: int = 4
    # Feature-width switching (filters/phd.py::_batched_update): run the
    # pre-half + merge on the map's live weight-sorted prefix ([:, :K/4]
    # or [:, :K/2]), lax.switched on the batch's max live count — exact
    # (zero-weight lanes contribute exactly nothing) and shrinks
    # everything that scales with the K capacity to the live fraction.
    # 1 = on (default; only engages for K >= 256), 0 = off.
    feature_width_switch: int = 1
    # Two-scan velocity initialization for dynamic births (mixed model):
    # 0 = reference semantics (zero velocity mean + covVx/VyBirth,
    # phdfilter.cu:267-281); 1 = seed the birth velocity mean from the
    # difference between the measurement's world position and the nearest
    # previous-scan measurement position (per particle), divided by the
    # scan interval cfg.dt. Pairing gated at birth_velocity_max * dt
    # meters (no pair -> zero velocity). A 10-run Monte-Carlo A/B gave a
    # detected fraction of 0.80 -> 0.60: the finite difference amplifies measurement noise by 1/dt (sigma_r
    # sqrt(2)/dt ~ 4.7 m/s at the MC protocol's sigma_r=0.5, dt=0.15 vs
    # mover speeds < 1 m/s, SNR ~ 0.1), so the seed is noise; ships OFF.
    # Worth revisiting only for low-noise / long-dt sensors where
    # v * dt >> sigma_r.
    birth_velocity_init: int = 0
    birth_velocity_max: float = 3.0
    # Separate stage-2 candidate cap for the mixed model's DYNAMIC map
    # (0 = use merge_candidate_cap). The dynamic map typically carries an
    # order of magnitude fewer live components than the static map (~75
    # vs ~400 at the MC protocol's scales), but the shared cap makes the
    # 4D gather/merge run at the static map's width.
    merge_candidate_cap_dynamic: int = 0
    # Mixed jump-Markov fast pipeline (filters/mixed.py): 0 = per-particle
    # reference-shaped route (merge inside vmap — the equivalence oracle),
    # 1 = batch-hoisted two-stage selection + batch 2D/4D merges.
    mixed_fast_path: int = 1
    # EAP extraction cadence (map_estimate bit 1): run the pairwise-tree
    # expected-map merge every N steps and the cheap MAP extraction in
    # between (1 = every step, the reference's behavior — it extracts every
    # step, main.cpp:1274). Cadence N amortizes the tree to ~1/N per step.
    eap_every: int = 1
    # Intermediate cluster cap for the pairwise EAP tree (0 = K). The
    # reference's ragged pairwise reduction (phdfilter.cu:3828-3863) never
    # truncates mid-tree; our fixed-capacity levels drop lowest-weight mass
    # when a pair's merged live count exceeds this cap. Per-level bound:
    # at most (live_in - cap) lowest-weight clusters drop, so total dropped
    # mass <= sum over levels of the tail below the cap'th weight. Raise to
    # 2K for high-diversity (pre-resample) particle sets.
    eap_tree_cap: int = 0
    # Neighbor-exchange resample migration on a particle mesh
    # (parallel/migrate.py): 0 = always the full all-gather, 1 = neighbor
    # ppermutes when feasible (fallback to the full gather otherwise).
    neighbor_migration: int = 1
    # Per-edge row budget for the neighbor exchange (0 = auto: block/2).
    migration_row_budget: int = 0

    # ------------------------------------------------------------------
    @property
    def clutter_density(self) -> float:
        # main.cpp:1064-1066
        return self.clutter_rate / (2.0 * self.max_bearing * self.max_range)

    @property
    def max_components(self) -> int:
        """K_max — per-particle GM capacity (reference: max_features)."""
        return self.max_features


# Mapping from reference config-file option names to SlamConfig field names.
_OPTION_MAP = {
    "debug": "debug",
    "initial_x": "x0",
    "initial_y": "y0",
    "initial_z": "z0",
    "initial_roll": "roll0",
    "initial_pitch": "pitch0",
    "initial_yaw": "yaw0",
    "initial_vx": "vx0",
    "initial_vy": "vy0",
    "initial_vz": "vz0",          # ref bug: wrote vy0 (main.cpp:970)
    "initial_vroll": "vroll0",    # ref bug: wrote vyaw0 (main.cpp:971)
    "initial_vpitch": "vpitch0",  # ref bug: wrote vyaw0 (main.cpp:972)
    "initial_vyaw": "vyaw0",
    "initial_theta": "yaw0",
    "initial_vtheta": "vyaw0",
    "follow_trajectory": "follow_trajectory",
    "motion_type": "motion_type",
    "acc_x": "ax",
    "acc_y": "ay",
    "acc_z": "az",
    "acc_roll": "aroll",
    "acc_pitch": "apitch",
    "acc_yaw": "ayaw",
    "acc_theta": "ayaw",
    "dt": "dt",
    "max_bearing": "max_bearing",
    "min_range": "min_range",
    "max_range": "max_range",
    "std_bearing": "std_bearing",
    "std_range": "std_range",
    "clutter_rate": "clutter_rate",
    "pd": "pd",
    "ps": "ps",
    "n_particles": "n_particles",
    "n_predict_particles": "n_predict_particles",
    "resample_threshold": "resample_threshold",
    "subdivide_predict": "subdivide_predict",
    "birth_weight": "birth_weight",
    "birth_noise_factor": "birth_noise_factor",
    "gate_births": "gate_births",
    "gated_births": "gate_births",
    "gate_measurements": "gate_measurements",
    "gate_threshold": "gate_threshold",
    "feature_model": "feature_model",
    "min_expected_feature_weight": "min_expected_feature_weight",
    "min_separation": "min_separation",
    "max_features": "max_features",
    "min_feature_weight": "min_feature_weight",
    "particle_weighting": "particle_weighting",
    "daughter_mixture_type": "daughter_mixture_type",
    "n_samples": "n_samples",
    "max_cardinality": "max_cardinality",
    "filter_type": "filter_type",
    "map_estimate": "map_estimate",
    "cphd_disttype": "cphd_dist_type",
    "nu": "nu",
    "distance_metric": "distance_metric",
    "h": "h",
    "l": "l",
    "a": "a",
    "b": "b",
    "std_encoder": "std_encoder",
    "std_alpha": "std_alpha",
    "std_vx_features": "std_vx_map",
    "std_vy_features": "std_vy_map",
    "std_ax_features": "std_ax_map",
    "std_ay_features": "std_ay_map",
    "cov_vx_birth": "cov_vx_birth",
    "cov_vy_birth": "cov_vy_birth",
    "std_u": "std_u",
    "std_v": "std_v",
    "disparity_birth": "disparity_birth",
    "image_width": "image_width",
    "image_height": "image_height",
    "std_d_birth": "std_d_birth",
    "fx": "fx",
    "fy": "fy",
    "u0": "u0",
    "v0": "v0",
    "particles_per_feature": "particles_per_feature",
    "tau": "tau",
    "beta": "beta",
    "labeled_measurements": "labeled_measurements",
    "data_directory": "data_directory",
    "max_time_steps": "max_time_steps",
    "save_all_maps": "save_all_maps",
    "save_prediction": "save_prediction",
    "n_steps": "n_steps",
    # additions without a reference counterpart
    "max_measurements": "max_measurements",
    "dtype": "dtype",
    "seed": "seed",
    "compute_variance": "compute_variance",
    "merge_candidate_cap": "merge_candidate_cap",
    "detection_topk": "detection_topk",
    "pallas_merge": "pallas_merge",
    "merge_r_par": "merge_r_par",
    "mixed_fast_path": "mixed_fast_path",
    "neighbor_migration": "neighbor_migration",
    "migration_row_budget": "migration_row_budget",
    "eap_every": "eap_every",
    "eap_tree_cap": "eap_tree_cap",
    "feature_width_switch": "feature_width_switch",
    "merge_candidate_cap_dynamic": "merge_candidate_cap_dynamic",
    "birth_velocity_init": "birth_velocity_init",
    "birth_velocity_max": "birth_velocity_max",
}

_LINE_RE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*=\s*(.*?)\s*$")


def _coerce(field_type, raw: str):
    if field_type is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if field_type is int:
        return int(float(raw))
    if field_type is float:
        return float(raw)
    return raw


def load_config(path: str, overrides: Optional[dict] = None) -> SlamConfig:
    """Parse a reference-format config file (``key = value``, ``#`` comments).

    Compatible with the boost::program_options config files shipped with the
    reference (/root/reference/cfg/config.cfg). Unknown keys are ignored with
    a warning, matching program_options' permissive behavior for commented
    defaults.
    """
    cfg = SlamConfig()
    fields = {f.name: f.type for f in dataclasses.fields(SlamConfig)}
    with open(path, "r") as fh:
        for line in fh:
            line = line.split("#", 1)[0]
            m = _LINE_RE.match(line)
            if not m:
                continue
            key, raw = m.group(1), m.group(2)
            name = _OPTION_MAP.get(key)
            if name is None:
                continue
            ftype = fields[name]
            if isinstance(ftype, str):  # from __future__ annotations
                ftype = {"bool": bool, "int": int, "float": float, "str": str}[ftype]
            setattr(cfg, name, _coerce(ftype, raw))
    if overrides:
        valid = {f.name for f in dataclasses.fields(SlamConfig)}
        for k, v in overrides.items():
            name = k if k in valid else _OPTION_MAP.get(k)
            if name is None or name not in valid:
                raise KeyError(f"unknown config override: {k!r}")
            setattr(cfg, name, v)
    return cfg
