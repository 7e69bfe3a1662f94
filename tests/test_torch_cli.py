"""The port's CLI (vct_tpu_torch/cli.py, `python -m vct_tpu_torch`) with
--cpu: tests/test_cli.py's five cases, and the rendered PNGs held against
the JAX CLI's on the same arguments: at most one level of 255 off on at
least 99.9% of the pixels (the two renders agree to about 1e-6 before
tonemapping, tests/test_torch_oracle.py).  Without --cpu the CLI runs on
the card, and with no card it raises rather than fall back."""

import os

import numpy as np
import pytest
import torch

from vct_tpu_torch import cli
from vct_tpu_torch.utils import image as I

torch.set_num_threads(1)    # all torch math on the main thread: PERF.md §7 item 4

SMALL = ["--dim", "16", "--width", "32", "--height", "24"]
ATRIUM = ["--scene", "atrium", "--camera", "48,-10,0", "--yaw", "180"]
MATCH_SHARE = 0.999


def hold_to_jax(out, args, tmp_path):
    from vct_tpu import cli as jcli
    ref = str(tmp_path / "jax.png")
    jcli.main(["render", *args, "--out", ref, "--cpu"])
    ours, theirs = I.read_png(out), I.read_png(ref)
    assert ours.shape == theirs.shape
    off = np.abs(ours.astype(np.int32) - theirs.astype(np.int32)).max(-1)
    assert np.mean(off <= 1) >= MATCH_SHARE, np.mean(off <= 1)


class TestCLI:
    def test_render_cornell(self, tmp_path):
        out = str(tmp_path / "img.png")
        cli.main(["render", *SMALL, "--out", out, "--cpu"])
        img = I.read_png(out)
        assert img.shape == (24, 32, 3)
        assert img.mean() > 1.0          # something lit
        hold_to_jax(out, SMALL, tmp_path)

    def test_render_atrium(self, tmp_path):
        out = str(tmp_path / "atrium.png")
        cli.main(["render", *ATRIUM, *SMALL, "--out", out, "--cpu"])
        img = I.read_png(out)
        assert img.shape == (24, 32, 3)
        assert img.mean() > 1.0
        hold_to_jax(out, [*ATRIUM, *SMALL], tmp_path)

    def test_debug_dump(self, tmp_path):
        out_dir = str(tmp_path / "dbg")
        cli.main(["debug", *SMALL, "--out-dir", out_dir, "--cpu"])
        for f in ("voxel_mip0.png", "occupancy.png", "light_volume.png",
                  "gbuffer_depth.png", "gbuffer_normal.png"):
            assert os.path.exists(os.path.join(out_dir, f)), f

    def test_orbit(self, tmp_path):
        out_dir = str(tmp_path / "orbit")
        cli.main(["orbit", *SMALL, "--frames", "2", "--out-dir", out_dir,
                  "--cpu"])
        assert os.path.exists(os.path.join(out_dir, "frame_001.png"))

    def test_without_cpu_runs_on_the_card(self, tmp_path):
        out = str(tmp_path / "card.png")
        if torch.cuda.is_available():
            cli.main(["render", *SMALL, "--out", out])
            assert I.read_png(out).shape == (24, 32, 3)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(["render", *SMALL, "--out", out])
            assert not os.path.exists(out)


class TestAtriumScene:
    def test_structure(self):
        from vct_tpu_torch.scene.atrium import atrium
        s = atrium()
        assert s.num_triangles > 500
        assert len(s.materials) == 8
        # textured slots exercised: albedo, height (bump), mask
        assert s.materials[0].albedo_texture is not None
        assert s.materials[0].height_texture is not None
        assert s.materials[4].mask_texture is not None
        # fits inside the default 150-unit grid
        assert np.abs(s.positions).max() < 75.0
