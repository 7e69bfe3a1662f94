"""The JAX package's own inverse-rendering gradients, fast camera pass
against the xla one, on the CPU: the reference figures that chip_smoke.py
path 6b holds the port to where tests/test_inverse_fast.py's bounds do
not hold.

tests/test_inverse_fast.py's setup at --dim^3 and --size x --size
(preset inverse; field diffuse and specular cones, volume shadows, a
6-direction basis, 2 diffuse cones, field_dim = dim): the Cornell box
from (3, 2, 140), or the textured atrium from the bench camera; the
target the xla render of the true scene times 0.7 plus 0.05.  For
--target (radiance, light, textures) prints each pass's loss and
gradient norm, and the fast gradient's cosine and norm ratio against
the xla one, as one JSON line.

    python scripts/jax_inverse_pairing.py --dim 64 --size 128

At preset inverse's size (64^3, 128x128) the Cornell radiance pairing
takes about a minute and 2 GB on one CPU.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from vct_tpu.config import preset  # noqa: E402
from vct_tpu.core import camera as cameralib  # noqa: E402
from vct_tpu.diff import inverse as I  # noqa: E402
from vct_tpu.render import renderer as R  # noqa: E402

CAMERAS = {"cornell": dict(position=(3.0, 2.0, 140.0)),
           "atrium": dict(position=(48.0, -10.0, 0.0), yaw=180.0)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--scene", choices=sorted(CAMERAS), default="cornell")
    ap.add_argument("--target", default="radiance")
    a = ap.parse_args()
    cfg = preset("inverse")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=a.dim),
        cones=dataclasses.replace(
            cfg.cones, diffuse_mode="field", specular_mode="field",
            field_dim=a.dim, field_basis=6, num_diffuse_cones=2),
        shadow=dataclasses.replace(cfg.shadow, mode="volume"),
        render=dataclasses.replace(cfg.render, width=a.size, height=a.size))
    if a.scene == "cornell":
        from vct_tpu.scene.cornell import cornell_box
        scene = cornell_box(size=100.0)
    else:
        from vct_tpu.scene.atrium import atrium
        scene = atrium()
    ds, mats, samples = R.prepare_scene(cfg, scene)
    camera = cameralib.Camera(**CAMERAS[a.scene])
    origins, dirs = cameralib.primary_rays(camera, a.size, a.size)
    cam = jnp.asarray(camera.position, jnp.float32)
    voxels = R.build_voxel_state(cfg, samples, mats)
    target = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam)
    target = target * 0.7 + 0.05
    out = dict(scene=a.scene, dim=a.dim, size=a.size, target=a.target)
    grads = {}
    for cpass in ("xla", "fast"):
        inv = I.InverseConfig(optimize=(a.target,), camera_pass=cpass)
        params = I.init_params(inv, cfg, mats, voxels)
        loss, g = jax.value_and_grad(I.make_loss_fn(inv, cfg, ds, cam))(
            params, samples, mats, origins, dirs, target)
        grads[cpass] = np.asarray(g[a.target], np.float64).ravel()
        out[f"loss_{cpass}"] = float(loss)
        out[f"norm_{cpass}"] = float(np.linalg.norm(grads[cpass]))
    gx, gf = grads["xla"], grads["fast"]
    out["cos"] = float(gx @ gf / (np.linalg.norm(gx) * np.linalg.norm(gf)))
    out["ratio"] = float(np.linalg.norm(gf) / np.linalg.norm(gx))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
