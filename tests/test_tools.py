"""Tools & subsystems tests: configurator generate, AAEC, custom subsystems,
ML hook, update scan."""

import json
import os

import numpy as np
import pytest


class TestConfiguratorGenerate:
    def test_generate_graph_roundtrip(self, tmp_path, monkeypatch):
        from chalkydri_tpu.runtime.graph import TaskGraph
        from chalkydri_tpu.tools.configurator import (
            CamConfigEntry,
            ConfiguratorState,
            generate_graph,
            main,
        )

        state = ConfiguratorState()
        e = CamConfigEntry(name="front", device_id="usb-0:1:1.0",
                           width=1600, height=1304, cam_id=0,
                           calib='{"OpenCVModel5": {"fx": 1, "fy": 1, "cx": 0, "cy": 0, "k1": 0, "k2": 0, "p1": 0, "p2": 0, "k3": 0}}')
        state.put("front", e)
        e2 = CamConfigEntry(name="back", device_id="usb-0:4:1.0", cam_id=1,
                            robot_to_cam={"roll": 0, "pitch": 0, "yaw": 180.0,
                                          "x": 0, "y": 0, "z": 0})
        state.put("back", e2)

        g = generate_graph(state)
        # save_cuconfig parity: 3 nodes per camera + typed edges + comm
        assert len(g.tasks) == 6
        assert len(g.edges) == 4
        assert g.resources[0].provider == "whacknet::CommBundle"
        assert g.node("apriltags_back").config["cam_id"] == 1
        assert json.loads(g.node("apriltags_back").config["robot_to_cam"])["yaw"] == 180.0

        # serialized graph parses back and keeps the chain structure
        g2 = TaskGraph.loads(g.dumps())
        assert len(g2.chains()) == 2

        # CLI flow: state file -> generate -> file
        monkeypatch.chdir(tmp_path)
        state.save("configurator.json")
        assert main(["--state", "configurator.json", "generate",
                     "--output", "out.ron"]) == 0
        g3 = TaskGraph.load("out.ron")
        assert [t.id for t in g3.tasks] == [t.id for t in g.tasks]


class TestConfiguratorInteractive:
    """VERDICT round-4 directive 8: the guided operator session
    (reference: dialoguer flow, configurator/src/main.rs:55-593, caps
    picker 518-568). A scripted-stdin walk of the full session must emit
    the SAME RON as the flag-driven path."""

    def test_scripted_session_matches_flag_path(self, tmp_path, monkeypatch):
        from chalkydri_tpu.tools.configurator import main

        monkeypatch.chdir(tmp_path)

        # Flag path: two cameras, one with offsets.
        assert main(["--state", "flags.json", "configure", "--name",
                     "front", "--device", "/dev/video0", "--width", "1280",
                     "--height", "800", "--cam-id", "0"]) == 0
        assert main(["--state", "flags.json", "configure", "--name",
                     "rear", "--device", "/dev/video2", "--width", "640",
                     "--height", "480", "--cam-id", "1", "--offsets",
                     '{"roll": 0.0, "pitch": 0.0, "yaw": 180.0, '
                     '"x": -0.25, "y": 0.0, "z": 0.5}']) == 0
        assert main(["--state", "flags.json", "generate", "--output",
                     "flags.ron"]) == 0

        # Interactive path: same rig through the guided session. No real
        # cameras in CI -> manual device entry + synthetic caps picker
        # (index 2 = 1280x800, index 0 = 640x480 in SYNTHETIC_CAPS).
        answers = iter([
            "front",            # camera name
            "/dev/video0",      # device
            "2",                # caps index -> 1280x800
            "0",                # cam_id
            "n",                # offsets?
            "n",                # calibrate?
            "rear",             # next camera
            "/dev/video2",
            "0",                # caps index -> 640x480
            "1",                # cam_id
            "y",                # offsets
            "-0.25", "0", "0.5",  # x y z
            "0", "0", "180",      # roll pitch yaw
            "n",                # calibrate?
            "",                 # finish camera loop
            "y",                # generate now?
            "inter.ron",        # output path
        ])
        monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
        assert main(["--state", "inter.json", "configure",
                     "--interactive"]) == 0

        flag_ron = (tmp_path / "flags.ron").read_text()
        inter_ron = (tmp_path / "inter.ron").read_text()
        assert inter_ron == flag_ron

    def test_session_eof_is_clean(self, tmp_path, monkeypatch):
        """Ctrl-D mid-session must exit 0 with state saved so far."""
        from chalkydri_tpu.tools.configurator import main

        monkeypatch.chdir(tmp_path)

        def eof(prompt=""):
            raise EOFError

        monkeypatch.setattr("builtins.input", eof)
        assert main(["--state", "s.json", "configure",
                     "--interactive"]) == 0


class TestExamples:
    """The in-tree runnable example inputs (examples/field_2026.json +
    examples/chalkydri.ron — the reference ships field.json and
    chalkydri.ron in-tree; VERDICT round-4 missing #2) must stay in sync
    with their generator and actually load."""

    ROOT = os.path.join(os.path.dirname(__file__), "..")

    def test_checked_in_files_match_generator(self, tmp_path):
        import importlib.util
        import shutil

        gen = os.path.join(self.ROOT, "examples", "gen_examples.py")
        work = tmp_path / "examples"
        work.mkdir()
        shutil.copy(gen, work / "gen_examples.py")
        spec = importlib.util.spec_from_file_location(
            "gen_examples", work / "gen_examples.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
        for name in ("field_2026.json", "chalkydri.ron"):
            fresh = (work / name).read_text()
            checked_in = open(
                os.path.join(self.ROOT, "examples", name)).read()
            assert fresh == checked_in, f"examples/{name} drifted — " \
                "regenerate with python examples/gen_examples.py"

    def test_example_graph_loads_and_chains(self):
        from chalkydri_tpu.runtime.graph import TaskGraph

        g = TaskGraph.load(
            os.path.join(self.ROOT, "examples", "chalkydri.ron"))
        assert len(g.chains()) == 2
        assert g.resources[0].provider == "whacknet::CommBundle"
        apr = g.node("apriltags_front")
        assert "OpenCVModel5" in apr.config["calib"]

    def test_example_field_parses_with_anchors(self):
        import jax.numpy as jnp

        from chalkydri_tpu.geometry.field_layout import parse_field_layout

        with open(os.path.join(
                self.ROOT, "examples", "field_2026.json")) as f:
            layout = parse_field_layout(json.load(f))
        assert int(np.asarray(layout.present).sum()) == 32
        assert abs(layout.field_size[0] - 16.518) < 1e-6
        # the tag-1 anchor the geometry parity tests assert
        assert abs(float(layout.tag_pose(jnp.array(1)).translation[0])
                   - 11.863959) < 1e-6


class TestAaec:
    def test_gradient_metric_prefers_contrast(self):
        from chalkydri_tpu.subsystems.aaec import compute_exposure_gradients
        import jax.numpy as jnp

        flat = np.full((1, 64, 64), 100, np.uint8)
        sharp = np.zeros((1, 64, 64), np.uint8)
        sharp[0, :, 32:] = 255
        g_flat = float(compute_exposure_gradients(jnp.asarray(flat))[0])
        g_sharp = float(compute_exposure_gradients(jnp.asarray(sharp))[0])
        assert g_sharp > g_flat + 1.0

    def test_controller_hill_climb(self):
        from chalkydri_tpu.subsystems.aaec import ExposureController

        # Metric peaked at exposure 200; the controller must climb toward it.
        ctrl = ExposureController(initial=100, step=10)
        exp = ctrl.exposure
        for _ in range(40):
            metric = -abs(exp - 200.0)
            exp = ctrl.update(metric)
        assert 150 <= exp <= 250


class TestCustomSubsys:
    def test_run_and_values(self):
        from chalkydri_tpu.runtime.clock import RobotClock, Stamped, Tov
        from chalkydri_tpu.subsystems.custom import PythonSubsys

        code = "def run(frame):\n    return {'mean': float(frame.mean())}\n"
        t = PythonSubsys(config={"name": "demo", "code": code})
        t.process(RobotClock(), Stamped(np.full((4, 4), 10, np.uint8), Tov(0)))
        assert t.last_values == {"mean": 10.0}

    def test_bad_code_rejected(self):
        from chalkydri_tpu.subsystems.custom import load_subsystem

        with pytest.raises(ValueError):
            load_subsystem("x", "y = 1\n")


class TestMlSubsys:
    def test_attach_and_run(self):
        import jax.numpy as jnp

        from chalkydri_tpu.runtime.clock import RobotClock, Stamped, Tov
        from chalkydri_tpu.subsystems.ml import MlSubsys

        t = MlSubsys()
        t.attach(lambda frame: jnp.mean(frame.astype(jnp.float32)))
        t.process(RobotClock(), Stamped(np.full((8, 8), 4, np.uint8), Tov(0)))
        assert float(t.last_output) == 4.0


class TestMlExample:
    def test_disk_finder_via_model_spec(self):
        """The example model resolves through MlSubsys's import-spec config
        (the MlSubsys {} slot surface) and localizes a rendered disk."""
        from chalkydri_tpu.runtime.clock import RobotClock, Stamped, Tov
        from chalkydri_tpu.subsystems.ml import MlSubsys

        t = MlSubsys(config={"model": "examples.ml_subsystem:model"})
        rng = np.random.default_rng(3)
        frame = rng.normal(120, 10, (240, 320)).astype(np.float32)
        yy, xx = np.mgrid[:240, :320]
        frame[(xx - 211) ** 2 + (yy - 87) ** 2 <= 20 * 20] = 235
        frame = np.clip(frame, 0, 255).astype(np.uint8)
        t.process(RobotClock(), Stamped(frame, Tov(0)))
        out = t.last_output
        assert abs(float(out["x"]) - 211) <= 3
        assert abs(float(out["y"]) - 87) <= 3


class TestUpdate:
    def test_scan_and_stage(self, tmp_path):
        from chalkydri_tpu.utils.update import scan_for_updates, stage_update

        pkg = tmp_path / "usb" / "chalkydri-update"
        pkg.mkdir(parents=True)
        (pkg / "manifest.json").write_text(
            json.dumps({"version": "1.2.0", "description": "test"})
        )
        (pkg / "payload.bin").write_bytes(b"x" * 10)
        found = scan_for_updates([str(tmp_path)])
        assert len(found) == 1 and found[0].version == "1.2.0"
        staged = stage_update(found[0], str(tmp_path / "staging"))
        assert os.path.exists(os.path.join(staged, "payload.bin"))


class TestSoak:
    def test_short_soak_reports_health(self, capsys):
        from chalkydri_tpu.tools.soak import main as soak_main

        rc = soak_main(["--seconds", "3", "--cams", "1", "--width", "320",
                        "--height", "240", "--json"])
        assert rc == 0
        import json as _json

        report = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["iterations"] >= 2
        assert report["packets_rx"] >= 1  # wire path exercised
        assert "app.dispatch" in report["spans"]
        # Latency-span decomposition: every span individually measured,
        # each a finite non-negative time, and the report names its device.
        spans = report["latency_spans"]
        for key in ("host_capture_ms", "h2d_put_ms", "device_step_ms",
                    "d2h_fetch_ms", "host_publish_ms"):
            assert key in spans, f"missing latency span {key}"
            assert 0.0 <= spans[key] < 60_000.0, (key, spans[key])
        assert spans["h2d_bytes"] == 1 * 240 * 320
        assert report["device"]["platform"] == "cpu"
        assert "capture_to_udp_ms_p999" in report


class TestImportHygiene:
    def test_package_import_does_not_initialize_jax_backend(self):
        """Importing chalkydri_tpu must not create device arrays at module
        scope: committing a backend at import time pins the platform
        before apps (or tests) can select one, and makes every import pay
        device start-up. Regression: geometry/transforms.py,
        detector/homography.py and subsystems/aaec.py once held
        module-level jnp constants. Run in a subprocess because this
        process's conftest already initialized a backend."""
        import subprocess
        import sys

        code = (
            "import jax\n"
            "import jax._src.xla_bridge as xb\n"
            "orig = xb.backends\n"
            "fired = []\n"
            "xb.backends = lambda *a, **k: (fired.append(1), orig(*a, **k))[1]\n"
            "import chalkydri_tpu\n"
            "import chalkydri_tpu.pipeline\n"
            "import chalkydri_tpu.detector.pipeline\n"
            "import chalkydri_tpu.solver.sqpnp\n"
            "import chalkydri_tpu.runtime.app\n"
            "import chalkydri_tpu.parallel.sharded_stages\n"
            "import chalkydri_tpu.subsystems.aaec\n"
            "assert not fired, 'package import initialized a JAX backend'\n"
            "print('CLEAN')\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=120, env=env,
        )
        assert out.returncode == 0, out.stderr
        assert "CLEAN" in out.stdout


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_env_var_is_used_and_nothing_else_is_set(self, monkeypatch,
                                                     tmp_path):
        import jax

        from chalkydri_tpu.utils.cache import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_the_checkouts_ignored_cache_dir(self, monkeypatch):
        import jax

        from chalkydri_tpu.utils.cache import enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = enable_compile_cache()
            assert jax.config.jax_compilation_cache_dir == path
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
        assert path == os.path.join(REPO, ".jax_cache")
        assert os.path.isdir(path)
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestDeviceInfo:
    def test_cpu_is_named_and_refused_for_measurement(self):
        from chalkydri_tpu.utils.device import device_info, require_gpu

        assert device_info() == {"platform": "cpu", "kind": "cpu",
                                 "count": 8}
        with pytest.raises(SystemExit, match="no GPU"):
            require_gpu()

    def test_stage_bytes_and_hbm_share(self):
        from chalkydri_tpu.tools.perfprobe import hbm_share, stage_bytes

        # uint8 frame in, uint8 ternary + int32 labels out.
        assert stage_bytes("threshold_ccl", 4, 400, 640) == 4 * 400 * 640 * 6
        n = stage_bytes("cluster_total", 1, 0, 0, n_cand=10, k=2, p=3)
        assert n == 3 * 4 * 10 + 4 * 4 * 2 * 3 + 2 * 3 + 5 * 2 + 4
        # 3.35 GB in 1 ms on a 3.35 TB/s card is its whole peak.
        assert hbm_share(int(3.35e9), 1.0, "NVIDIA H100 80GB HBM3") == \
            pytest.approx(1.0)
        with pytest.raises(KeyError):
            hbm_share(1, 1.0, "cpu")
        with pytest.raises(ValueError):
            stage_bytes("decode", 1, 1, 1)


def _chip_smoke():
    import importlib

    return importlib.import_module("chip_smoke")


class TestChipSmoke:
    """chip_smoke.py runs only on a GPU; here its refusal, its numpy
    scene renderer and its comparators are checked at tiny sizes."""

    @pytest.mark.parametrize("alone", [False, True])
    def test_exits_nonzero_without_gpu_or_repo(self, tmp_path, alone):
        import shutil
        import subprocess
        import sys

        script = os.path.join(REPO, "chip_smoke.py")
        cwd = REPO
        if alone:
            shutil.copy(script, tmp_path)
            script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

    def test_renderer_truth_lies_on_the_drawn_tags(self):
        cs = _chip_smoke()
        tags = cs.load_tags()
        frames, truth = cs.render_field_frames(tags, 2, 400, 640, 450.0)
        assert frames.shape == (2, 400, 640) and frames.dtype == np.uint8
        for b, t in enumerate(truth):
            assert len(t["corners"]) == 2
            for c in t["corners"].values():
                assert c.shape == (4, 2)
                assert (c[:, 0] > 0).all() and (c[:, 0] < 640).all()
                assert (c[:, 1] > 0).all() and (c[:, 1] < 400).all()
                # Just inside each corner (toward the centre) is the
                # tag's black border.
                for p in c + 0.1 * (c.mean(axis=0) - c):
                    assert frames[b, int(p[1]), int(p[0])] < 60
            # The corners project back from the tag poses at the truth pose.
            calib = {"fx": 450.0, "fy": 450.0, "cx": 320.0, "cy": 200.0}
            for tid, c in t["corners"].items():
                pix, depth = cs.project(cs.tag_corners_world(*tags[tid]),
                                        t["xy"], t["yaw"], calib)
                assert (depth > 0).all()
                np.testing.assert_allclose(pix, c, atol=1e-9)
        assert (frames[:, 0, 0] == 150).all()  # untouched background

    def test_scene_warp_meets_the_detector_corner_gate(self):
        """tools.scene draws corners where the detector finds them
        (< 0.1 px on a clean scene), so it can stand as ground truth."""
        import jax.numpy as jnp

        from chalkydri_tpu.detector import load_family, make_detector
        from chalkydri_tpu.tools.scene import place_tag

        canvas = np.full((240, 320), 150, np.uint8)
        want = place_tag(canvas, load_family("tag36h11"), 7,
                         [[95, 190], [215, 185], [210, 70], [100, 60]])
        det = make_detector(quad_decimate=1)(jnp.asarray(canvas)[None])
        valid = np.asarray(det.valid[0])
        assert np.asarray(det.ids[0])[valid].tolist() == [7]
        got = np.asarray(det.corners[0])[valid][0]
        assert np.abs(got - want).max() < 0.1

    def _truth_and_output(self):
        cs = _chip_smoke()
        c1 = np.array([[10, 20], [30, 20], [30, 0], [10, 0]], np.float64)
        truth = [{"xy": np.array([1.0, 2.0]), "yaw": np.pi - 1e-3,
                  "corners": {3: c1, 4: c1 + 50}}]
        out = {"ids": np.array([[4, 3, -1]]),
               "corners": np.stack([c1 + 50, c1 + 0.05, 0 * c1])[None],
               "valid": np.array([[True, True, False]]),
               "pose_valid": np.array([True]), "tag_count": np.array([2]),
               "pose_x": np.array([1.01]), "pose_y": np.array([2.0]),
               "pose_yaw": np.array([-np.pi + 1e-3])}
        return cs, truth, out

    def test_compare_to_truth(self):
        cs, truth, out = self._truth_and_output()
        err = cs.compare_to_truth(out, truth)
        assert err["corner_px"] == pytest.approx(0.05)
        assert err["xy_m"] == pytest.approx(0.01)
        assert err["yaw_rad"] == pytest.approx(2e-3)  # across the +-pi wrap
        for key, bad in (("ids", np.array([[5, 3, -1]])),
                         ("pose_valid", np.array([False])),
                         ("tag_count", np.array([1]))):
            with pytest.raises(cs.PhaseFailed):
                cs.compare_to_truth(dict(out, **{key: bad}), truth)

    def test_compare_outputs(self):
        cs, _, out = self._truth_and_output()
        assert cs.compare_outputs(out, out) == {
            "corner_px": 0.0, "xy_m": 0.0, "yaw_rad": 0.0}
        moved = dict(out, corners=out["corners"] + 0.01,
                     pose_yaw=out["pose_yaw"] - 2e-3)
        err = cs.compare_outputs(out, moved)
        assert err["corner_px"] == pytest.approx(0.01)
        assert err["yaw_rad"] == pytest.approx(2e-3)
        with pytest.raises(cs.PhaseFailed, match="valid"):
            cs.compare_outputs(out, dict(out, valid=~out["valid"]))


class TestPerfprobeHetero:
    def test_hetero_mode_smoke_cpu(self, capsys, monkeypatch):
        """`perfprobe --hetero` (the mixed-rig characterization) must run
        off-device with --cpu: builds two geometry groups, probes
        each alone and the pair, reports pair_vs_sum. CPU numbers are not
        device numbers — this pins the probe paths."""
        import sys as _sys

        from chalkydri_tpu.tools.perfprobe import main as probe_main

        monkeypatch.setattr(_sys, "argv", [
            "perfprobe", "--cpu", "--hetero",
            "--hetero-w1", "320", "--hetero-h1", "240",
            "--hetero-w2", "256", "--hetero-h2", "160",
        ])
        probe_main()
        import json as _json

        out = capsys.readouterr().out.strip().splitlines()[-1]
        report = _json.loads(out)["perfprobe_ms"]
        assert "group_A_2x320x240" in report
        assert "group_B_2x256x160" in report
        assert "rig_pair_AB" in report
        assert report["pair_vs_sum"] > 0
