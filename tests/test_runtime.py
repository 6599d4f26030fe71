"""Checkpoint/resume, batch harness, and CLI driver tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.config import SlamConfig
from phdslam_tpu.eval.batch import generate_batch_datasets, run_batch
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.runtime.checkpoint import (load_checkpoint,
                                            profile_single_update,
                                            save_checkpoint)
from phdslam_tpu.types import init_state


def small_cfg(**kw):
    d = dict(n_particles=8, max_features=16, max_measurements=8,
             motion_type=1, feature_model=0, filter_type=0,
             l=2.83, h=0.76, a=3.78, b=0.5, std_encoder=2.0,
             std_alpha=0.0873, max_range=10.0, std_range=1.0,
             std_bearing=0.0349, clutter_rate=5.0, pd=0.95,
             birth_weight=0.05, min_separation=5.0, particle_weighting=0,
             resample_threshold=0.15, dt=0.1, seed=9)
    d.update(kw)
    return SlamConfig(**d)


def test_checkpoint_roundtrip(tmp_path):
    cfg = small_cfg()
    step = make_step_fn(cfg, donate=False)
    state = init_state(cfg)
    z = jnp.asarray([[5.0, 0.2], [7.0, -0.3]] + [[0, 0]] * 6, jnp.float32)
    mask = jnp.asarray([True, True] + [False] * 6)
    for n in range(3):
        state, _ = step(state, z, mask, jnp.asarray([1.0, 0.05], jnp.float32),
                        jnp.float32(0.1), jnp.asarray(n > 0))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    restored = load_checkpoint(path, init_state(cfg))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    """Resuming a checkpoint saved under different capacities must fail
    with a clear shape-mismatch error, not an opaque downstream jit error
    (advisor, round 3 — the numpy layout restored raw leaves unchecked)."""
    import pytest

    cfg = small_cfg()
    state = init_state(cfg)
    path = str(tmp_path / "ckpt_np")
    save_checkpoint(path, state)

    cfg2 = small_cfg(n_particles=cfg.n_particles * 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, init_state(cfg2))
    # matching config still restores
    restored = load_checkpoint(path, init_state(cfg))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profile_single_update(tmp_path):
    cfg = small_cfg()
    state = init_state(cfg)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    res = profile_single_update(cfg, path)
    assert np.isfinite(res["est_poses"]).all()
    assert res["update_ms"] > 0


@pytest.fixture(scope="module")
def batch_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("batch"))
    generate_batch_datasets(root, n_runs=2, n_landmarks=15, n_steps=30,
                            seed=3)
    return root


def test_batch_run_and_analyze(batch_root):
    cfg = small_cfg(n_particles=16, max_features=32, max_measurements=32,
                    clutter_rate=20.0)
    cfg.data_directory = batch_root
    res = run_batch(cfg, batch_root, ospa_every=10)
    s = res.summary()
    assert s["n_runs"] == 2
    assert np.isfinite(s["mean_pose_err"])
    assert np.isfinite(s["mean_ospa"])
    assert res.pose_err.shape[0] == 2
    # a working filter on 30 easy steps should stay under a few meters
    assert s["mean_pose_err"] < 8.0


def test_cli_synth(batch_root, tmp_path, capsys):
    from phdslam_tpu.__main__ import main
    cfg_path = str(tmp_path / "t.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
                 "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
                 "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
                 "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
                 "clutter_rate = 20\npd = 0.95\nfilter_type = 0\n"
                 f"data_directory = {batch_root}/run000\n")
    out_dir = str(tmp_path / "out")
    rc = main([cfg_path, "synth", "--out-dir", out_dir, "--steps", "12",
               "--runner", "chunked"])
    assert rc == 0
    logs = [f for f in os.listdir(out_dir) if f.startswith("state_estimate")]
    assert len(logs) == 12
    assert os.path.exists(os.path.join(out_dir, "loopTime.log"))
    assert os.path.exists(os.path.join(out_dir, "config.cfg"))


def test_cli_disparity(tmp_path):
    from phdslam_tpu.__main__ import main
    from phdslam_tpu.eval.simdata import (generate_disparity_world,
                                          write_disparity_run_dir)

    lm, traj, meas = generate_disparity_world(n_landmarks=10, n_steps=12,
                                              seed=2)
    ddir = str(tmp_path / "disp")
    write_disparity_run_dir(ddir, meas)
    cfg_path = str(tmp_path / "d.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("n_particles = 8\nmax_features = 12\nmax_measurements = 16\n"
                 "particles_per_feature = 16\nfx = 500\nfy = 500\n"
                 "u0 = 320\nv0 = 240\nimage_width = 640\nimage_height = 480\n"
                 "std_u = 1\nstd_v = 1\ndisparity_birth = 150\n"
                 "std_d_birth = 100\nclutter_rate = 2\npd = 0.95\n"
                 "birth_weight = 0.05\nmin_separation = 20\n"
                 "particle_weighting = 0\ndt = 0.5\ninitial_vx = 0.1\n"
                 f"data_directory = {ddir}\n")
    out_dir = str(tmp_path / "out")
    rc = main([cfg_path, "disparity", "--out-dir", out_dir])
    assert rc == 0
    import numpy as np
    est = np.loadtxt(out_dir + "/trajectory.txt")
    assert est.shape[0] == 12
    assert np.isfinite(est).all()


def test_disparity_follow_trajectory(tmp_path):
    """follow_trajectory: single-particle mapping with known camera poses."""
    import numpy as np

    from phdslam_tpu.config import SlamConfig
    from phdslam_tpu.eval.simdata import (generate_disparity_world,
                                          write_disparity_run_dir)
    from phdslam_tpu.slam_disparity import run_disparity

    lm, traj, meas = generate_disparity_world(n_landmarks=8, n_steps=15,
                                              seed=3, clutter_rate=0.5)
    ddir = str(tmp_path / "disp")
    write_disparity_run_dir(ddir, meas)
    np.savetxt(ddir + "/traj.txt", traj)
    cfg = SlamConfig(
        follow_trajectory=True, n_particles=4, max_features=12,
        max_measurements=16, particles_per_feature=16, fx=500.0, fy=500.0,
        u0=320.0, v0=240.0, image_width=640, image_height=480,
        std_u=1.0, std_v=1.0, disparity_birth=150.0, std_d_birth=100.0,
        clutter_rate=0.5, pd=0.95, birth_weight=0.05, min_separation=20.0,
        particle_weighting=0, dt=0.5, seed=4)
    res = run_disparity(cfg, ddir)
    assert cfg.n_particles == 1
    # known poses: the estimated camera trajectory equals the input
    np.testing.assert_allclose(res["est_poses"][-1][:3], traj[-1][:3],
                               atol=1e-5)
    w = np.asarray(res["final_state"].feat_weight[0])
    assert (w > 0.3).sum() >= 4  # mapped a good chunk of the landmarks


def test_log_roundtrip_analysis(batch_root, tmp_path):
    """Write state logs via the runner, re-parse them with the
    batch_analyze-equivalent, and check the scores match the in-memory path."""
    import numpy as np

    from phdslam_tpu.eval.batch import analyze_log_dir, parse_state_log
    from phdslam_tpu.slam import SynthSLAMRunner

    cfg = small_cfg(n_particles=16, max_features=32, max_measurements=32,
                    clutter_rate=20.0)
    out_dir = str(tmp_path / "logs")
    runner = SynthSLAMRunner(cfg, batch_root + "/run000")
    res = runner.run_chunked(chunk=16, collect_maps=True,
                             collect_particles=True)
    runner.write_logs(out_dir, res)
    gt = np.load(batch_root + "/groundtruth.npz")
    scores = analyze_log_dir(out_dir, gt["traj"], gt["landmarks"],
                             ospa_every=5)
    assert np.isfinite(scores["mean_pose_err"])
    assert np.isfinite(scores["mean_ospa"])
    # parsed pose matches the in-memory estimate
    rec = parse_state_log(out_dir + "/state_estimate00005.log")
    np.testing.assert_allclose(rec["est_pose"], res["est_poses"][5][:3],
                               rtol=1e-4, atol=1e-4)
    # parsed particle weights normalize
    np.testing.assert_allclose(np.exp(rec["log_weights"]).sum(), 1.0,
                               rtol=1e-3)


def test_checkpoint_resume_sharded(tmp_path):
    """Preemption recovery on the 8-device mesh (SURVEY.md §5): checkpoint a
    sharded run mid-sequence, restore onto a fresh mesh, and continue — the
    resumed trace must equal the uninterrupted one exactly (the PRNG key and
    step counter live in the state, so the recursion is deterministic)."""
    import jax

    from phdslam_tpu.parallel import (init_sharded_state, make_mesh,
                                      make_sharded_step_fn)
    from phdslam_tpu.parallel.sharding import shard_state

    assert jax.device_count() >= 8
    mesh = make_mesh(8, devices=jax.devices("cpu"))
    cfg = small_cfg(n_particles=16)
    step = make_sharded_step_fn(cfg, mesh, donate=False)
    z = jnp.asarray([[5.0, 0.2], [7.0, -0.3]] + [[0, 0]] * 6, jnp.float32)
    mask = jnp.asarray([True, True] + [False] * 6)
    ctrl = jnp.asarray([1.0, 0.05], jnp.float32)

    ref = init_sharded_state(cfg, mesh)
    for n in range(6):
        ref, ref_out = step(ref, z, mask, ctrl, jnp.float32(0.1),
                            jnp.asarray(n > 0))

    st = init_sharded_state(cfg, mesh)
    for n in range(3):
        st, _ = step(st, z, mask, ctrl, jnp.float32(0.1), jnp.asarray(n > 0))
    path = str(tmp_path / "ckpt_sharded")
    save_checkpoint(path, st)

    restored = load_checkpoint(path, init_state(cfg))   # host pytree
    st2 = shard_state(make_mesh(8, devices=jax.devices("cpu")),
                      restored)                         # back onto a mesh
    for n in range(3, 6):
        st2, out = step(st2, z, mask, ctrl, jnp.float32(0.1),
                        jnp.asarray(True))

    np.testing.assert_allclose(np.asarray(out.expected_pose),
                               np.asarray(ref_out.expected_pose),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(jax.tree.leaves(st2), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_cv_motion_mc_batch(tmp_path):
    """CV-vehicle Monte-Carlo acceptance (the measurements_synth_cv
    protocol): generate a controls-free CV world, run the motion_type=0
    filter over noise realizations, and require bounded pose error."""
    from phdslam_tpu.eval.batch import generate_batch_datasets, run_batch

    root = str(tmp_path / "cvmc")
    generate_batch_datasets(root, n_runs=2, n_landmarks=20, n_steps=40,
                            seed=7, motion="cv")
    assert not os.path.exists(os.path.join(root, "run000", "controls.txt"))
    cfg = small_cfg(n_particles=64, max_features=32, max_measurements=48,
                    motion_type=0)
    cfg.vx0, cfg.vyaw0 = 3.0, 0.15      # CV prior matches the generator
    cfg.ax, cfg.ayaw = 0.5, 0.05
    cfg.max_range, cfg.std_range, cfg.std_bearing = 10.0, 1.0, 0.0349
    cfg.clutter_rate = 20.0
    res = run_batch(cfg, root, ospa_every=10)
    s = res.summary()
    assert np.isfinite(s["mean_pose_err"])
    assert s["mean_pose_err"] < 4.0, s
    assert np.isfinite(res.n_eff).all()


def test_cli_periodic_checkpoint_and_resume(batch_root, tmp_path):
    """--checkpoint-every saves INSIDE the chunked loop (main.cpp:1262-1269
    role, periodic); --resume continues from the saved state and the final
    estimates match an uninterrupted run (deterministic per-(step, particle)
    keys make the resumed trajectory bit-identical)."""
    from phdslam_tpu.__main__ import main
    cfg_path = str(tmp_path / "t.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
                 "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
                 "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
                 "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
                 "clutter_rate = 20\npd = 0.95\nfilter_type = 0\n"
                 f"data_directory = {batch_root}/run000\n")

    full_dir = str(tmp_path / "full")
    rc = main([cfg_path, "synth", "--out-dir", full_dir, "--steps", "16",
               "--runner", "chunked", "--chunk", "4"])
    assert rc == 0

    ck_dir = str(tmp_path / "ck")
    rc = main([cfg_path, "synth", "--out-dir", ck_dir, "--steps", "16",
               "--runner", "chunked", "--chunk", "4",
               "--checkpoint-every", "8"])
    assert rc == 0
    ckpts = sorted(os.listdir(os.path.join(ck_dir, "checkpoints")))
    assert "step00008" in ckpts, ckpts     # saved MID-run, not only at end

    res_dir = str(tmp_path / "resumed")
    rc = main([cfg_path, "synth", "--out-dir", res_dir, "--steps", "16",
               "--runner", "chunked", "--chunk", "4", "--resume",
               os.path.join(ck_dir, "checkpoints", "step00008")])
    assert rc == 0

    # the resumed run's post-resume estimates equal the uninterrupted run's
    last_full = sorted(f for f in os.listdir(full_dir)
                       if f.startswith("state_estimate"))[-1]
    with open(os.path.join(full_dir, last_full)) as fh:
        full_pose = fh.readline().split()
    with open(os.path.join(res_dir, last_full)) as fh:
        res_pose = fh.readline().split()
    np.testing.assert_allclose([float(x) for x in res_pose],
                               [float(x) for x in full_pose], rtol=1e-6)

    # loopTime.log carries true per-step (chunk-granular) wall times, not
    # one repeated run average
    times = np.loadtxt(os.path.join(ck_dir, "loopTime.log"))
    assert len(times) == 16
    assert len(np.unique(times)) > 1, "loopTime.log is a repeated average"


def test_resume_restores_carried_control(tmp_path):
    """Timestamped schedules have measurement-only steps whose predict
    reuses the LAST APPLIED control (main.cpp:1192-1229); a resumed chunked
    run must restore that carried control from the checkpoint, not reset it
    to zero (round-2 advisor finding). Pinned by bit-comparing a resumed
    run against the uninterrupted one across a boundary that lands between
    a control step and a measurement-only step."""
    import jax.numpy as jnp

    from phdslam_tpu.__main__ import main

    # interleaved timestamps: z at .25, .75, 1.25, ...; c at .5, 1.0, ...
    # -> alternating measurement-only / control-only steps
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    n = 10
    with open(data / "measurements.txt", "w") as fh:
        fh.write("% header\n")
        for _ in range(n):
            r = rng.uniform(1, 8, 3)
            b = rng.uniform(-1, 1, 3)
            fh.write(" ".join(f"{x:.4f} {y:.4f}" for x, y in zip(r, b))
                     + " \n")
    with open(data / "controls.txt", "w") as fh:
        fh.write("% header\n")
        for _ in range(n):
            fh.write("1.5 0.05\n")
    with open(data / "measurement_times.txt", "w") as fh:
        fh.write("\n".join(f"{0.25 + 0.5 * i:.2f}" for i in range(n)) + "\n")
    with open(data / "control_times.txt", "w") as fh:
        fh.write("\n".join(f"{0.5 + 0.5 * i:.2f}" for i in range(n)) + "\n")

    cfg_path = str(tmp_path / "t.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
                 "max_measurements = 8\nl = 2.83\nh = 0.76\na = 3.78\n"
                 "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
                 "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
                 "clutter_rate = 20\npd = 0.95\nfilter_type = 0\n"
                 f"data_directory = {data}\n")

    full_dir = str(tmp_path / "full")
    assert main([cfg_path, "synth", "--out-dir", full_dir, "--steps", "16",
                 "--runner", "chunked", "--chunk", "4"]) == 0
    ck_dir = str(tmp_path / "ck")
    assert main([cfg_path, "synth", "--out-dir", ck_dir, "--steps", "16",
                 "--runner", "chunked", "--chunk", "4",
                 "--checkpoint-every", "8"]) == 0
    res_dir = str(tmp_path / "resumed")
    assert main([cfg_path, "synth", "--out-dir", res_dir, "--steps", "16",
                 "--runner", "chunked", "--chunk", "4", "--resume",
                 os.path.join(ck_dir, "checkpoints", "step00008")]) == 0

    last = sorted(f for f in os.listdir(full_dir)
                  if f.startswith("state_estimate"))[-1]
    with open(os.path.join(full_dir, last)) as fh:
        full_pose = [float(x) for x in fh.readline().split()]
    with open(os.path.join(res_dir, last)) as fh:
        res_pose = [float(x) for x in fh.readline().split()]
    np.testing.assert_allclose(res_pose, full_pose, rtol=1e-6)

    # --resume with a non-chunked runner is rejected (start_step would be
    # silently ignored and the schedule replayed from 0)
    with pytest.raises(SystemExit):
        main([cfg_path, "synth", "--out-dir", str(tmp_path / "x"),
              "--steps", "16", "--runner", "scanned", "--resume",
              os.path.join(ck_dir, "checkpoints", "step00008")])

    # resuming at/past the end of the schedule raises a clear error
    from phdslam_tpu.config import load_config
    from phdslam_tpu.slam import SynthSLAMRunner
    cfg = load_config(cfg_path)
    cfg.n_steps = 16
    r = SynthSLAMRunner(cfg)
    with pytest.raises(ValueError, match="past the end"):
        r.run_chunked(chunk=4, start_step=16)


def test_cli_timing_logs(batch_root, tmp_path):
    """--timing: per-step loopTime.log + predicttime.log (the reference's
    CUDA-event prediction timing, phdfilter.cu:1244-1251)."""
    from phdslam_tpu.__main__ import main
    cfg_path = str(tmp_path / "t.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
                 "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
                 "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
                 "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
                 "clutter_rate = 20\npd = 0.95\nfilter_type = 0\n"
                 f"data_directory = {batch_root}/run000\n")
    out_dir = str(tmp_path / "timed")
    rc = main([cfg_path, "synth", "--out-dir", out_dir, "--steps", "8",
               "--timing"])
    assert rc == 0
    lt = np.loadtxt(os.path.join(out_dir, "loopTime.log"))
    pt = np.loadtxt(os.path.join(out_dir, "predicttime.log"))
    assert len(lt) == 8 and len(pt) == 8
    assert len(np.unique(lt)) > 1          # true per-step times
    assert (pt[1:] > 0).all()              # predict timed on predict steps


def test_cli_replay_artifact(batch_root, tmp_path):
    """--replay gif: animated 4-panel replay + weight-inspector figure
    (plot_phdslam.py:35-258 + examineWeights.m roles)."""
    from phdslam_tpu.__main__ import main
    cfg_path = str(tmp_path / "t.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("motion_type = 1\nn_particles = 8\nmax_features = 16\n"
                 "max_measurements = 16\nl = 2.83\nh = 0.76\na = 3.78\n"
                 "b = 0.5\nstd_encoder = 2\nstd_alpha = 0.0873\n"
                 "max_range = 10\nstd_range = 1\nstd_bearing = 0.0349\n"
                 "clutter_rate = 20\npd = 0.95\nfilter_type = 1\n"
                 "max_cardinality = 24\n"
                 f"data_directory = {batch_root}/run000\n")
    out_dir = str(tmp_path / "rep")
    rc = main([cfg_path, "synth", "--out-dir", out_dir, "--steps", "10",
               "--runner", "chunked", "--chunk", "5",
               "--replay", "gif", "--replay-every", "4"])
    assert rc == 0
    gif = os.path.join(out_dir, "replay", "replay.gif")
    assert os.path.exists(gif) and os.path.getsize(gif) > 1000
    wi = os.path.join(out_dir, "weights.png")
    assert os.path.exists(wi) and os.path.getsize(wi) > 1000
