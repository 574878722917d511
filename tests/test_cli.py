"""CLI tests — flag surface parity with the reference driver
(src/main.cpp:430-535) plus the fixed -w and the strategy mapping."""

import numpy as np
import pytest

from esctp1raytracer_tpu.cli import build_parser, main, self_test
from esctp1raytracer_tpu.io.ppm import read_ppm
from esctp1raytracer_tpu.scene.builders import write_cornell_obj


@pytest.fixture()
def cornell_obj(tmp_path):
    path = str(tmp_path / "cornell.obj")
    write_cornell_obj(path)
    return path


class TestParser:
    def test_defaults_match_reference(self):
        args = build_parser().parse_args([])
        assert args.eye == (0.0, 1.0, 3.0)
        assert args.look == (0.0, 1.0, 0.0)
        assert args.window == (1024, 768)
        assert args.vfov == 60.0

    def test_vec_parsing(self):
        args = build_parser().parse_args(["-v", "0,1,2", "-l", "3,4,5"])
        assert args.eye == (0.0, 1.0, 2.0)
        assert args.look == (3.0, 4.0, 5.0)

    def test_window_flag_works(self):
        # Reference quirk 7: -w parsed into `look`. Fixed here.
        args = build_parser().parse_args(["-w", "320,200"])
        assert args.window == (320, 200)
        assert args.look == (0.0, 1.0, 0.0)

    def test_bad_vec_rejected(self):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["-v", "1,2"])

    def test_unknown_flag_rejected(self):
        # Reference throws "Invalid Argument" (src/main.cpp:531-534).
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--bogus"])

    def test_strategy_flags(self):
        args = build_parser().parse_args(["--thread", "--bvh", "--ispc"])
        assert args.thread and args.bvh and args.ispc


class TestSelfTest:
    def test_self_test_passes(self, capsys):
        assert self_test() == 0
        out = capsys.readouterr().out
        assert "4/4 passed" in out

    def test_flag_runs_and_exits(self, capsys):
        assert main(["--test"]) == 0


class TestEndToEnd:
    def test_render_obj_to_ppm(self, cornell_obj, tmp_path, capsys):
        out = str(tmp_path / "out.ppm")
        rc = main(["-m", cornell_obj, "-v", "0,1,2", "-l", "0,1,0",
                   "-w", "48,36", "-o", out])
        assert rc == 0
        assert f"Rendered image in: {out}" in capsys.readouterr().out
        img = read_ppm(out)
        assert img.shape == (36, 48, 3)
        assert img.max() > 0.1

    def test_no_output_message(self, cornell_obj, capsys):
        rc = main(["-m", cornell_obj, "-w", "16,12"])
        assert rc == 0
        assert "Nothing saved" in capsys.readouterr().out

    def test_no_model_errors(self, capsys):
        assert main([]) == 2

    def test_procedural_scene(self, tmp_path):
        out = str(tmp_path / "s.ppm")
        rc = main(["--scene", "sphere_plane", "-v", "0,2,6", "-l", "0,1,0",
                   "-w", "32,32", "-o", out])
        assert rc == 0
        assert read_ppm(out).shape == (32, 32, 3)

    @pytest.mark.parametrize("flags,mode_field", [
        (["--ispc"], "ISPC"),
        (["--thread"], "Threaded"),
        (["--bvh"], "Flattened"),
    ])
    def test_strategy_matrix_runs(self, cornell_obj, tmp_path, capsys, flags, mode_field):
        out = str(tmp_path / "m.ppm")
        rc = main(["-m", cornell_obj, "-w", "32,24", "-o", out] + flags)
        assert rc == 0
        err = capsys.readouterr().err
        assert f"{mode_field}" in err


class TestModeBackendComposition:
    def test_sharded_with_explicit_backend(self, cornell_obj, tmp_path, capsys):
        # --mode sharded composes with any kernel backend (the reference's
        # --thread composes with --bvh/--ispc the same way).
        out = str(tmp_path / "st.ppm")
        rc = main(["-m", cornell_obj, "-w", "24,18", "-o", out,
                   "--mode", "sharded", "--backend", "mxu"])
        assert rc == 0
        assert "sharded/mxu" in capsys.readouterr().err
        assert read_ppm(out).shape == (18, 24, 3)

    def test_bvh_thread_maps_to_sharded_auto(self, cornell_obj, tmp_path, capsys):
        out = str(tmp_path / "bt.ppm")
        rc = main(["-m", cornell_obj, "-w", "24,18", "-o", out,
                   "--bvh", "--thread"])
        assert rc == 0
        assert "sharded/auto" in capsys.readouterr().err

    def test_legacy_mode_backend_shorthand(self, cornell_obj, capsys):
        # --mode <backend> keeps working as shorthand for --backend.
        rc = main(["-m", cornell_obj, "-w", "16,12", "--mode", "mxu"])
        assert rc == 0
        assert "single/mxu" in capsys.readouterr().err


class TestExplicitBackends:
    @pytest.mark.parametrize("mode", ["jnp", "mxu", "auto"])
    def test_mode_flag_renders(self, cornell_obj, tmp_path, mode):
        """Every kernel backend must be selectable from the CLI (the
        reproduce-the-auto-decision workflow)."""
        out = str(tmp_path / f"{mode}.ppm")
        rc = main(["-m", cornell_obj, "-w", "24,18", "-o", out,
                   "--mode", mode])
        assert rc == 0
        img = read_ppm(out)
        assert img.shape == (18, 24, 3)
        assert img.max() > 0.1


@pytest.mark.parametrize("name", ["lane", "tile", "mxtile", "fused", "pallas"])
def test_removed_backends_are_refused(cornell_obj, name):
    with pytest.raises(SystemExit):
        main(["-m", cornell_obj, "-w", "16,12", "--backend", name])
