"""Scene container and text-format loaders.

Reference: ``include/scene.h``.  The text format (scene.h:38-120):

    Light:    l x y z  r g b
    Gaussian: g x y z  cxx cxy cxz cyy cyz czz  density albedo [er eg eb]
    Sphere:   s x y z  radius sigma_a sigma_s

Unknown leading tokens are skipped line-wise (the reference skips unknown
tokens in a token stream; for well-formed files the semantics agree and
comment lines survive either way).  Default environment radiance is the
reference's sky blue (scene.h:29).
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from gvr.scene.gaussians import GaussianMixture
from gvr.scene.spheres import SphereMixture

DEFAULT_ENV_COLOR = (0.53, 0.81, 0.92)


@dataclasses.dataclass
class Light:
    """Point light (scene.h:12-15)."""
    position: np.ndarray
    intensity: np.ndarray


@jax.tree_util.register_pytree_node_class
class Scene:
    """Volume + lights + environment.

    ``medium`` is a GaussianMixture or SphereMixture; which one is static
    (part of the pytree structure), mirroring the reference's
    ``VolumeType`` dispatch (scene.h:18-22, 128-204) resolved at trace time.

    lights_p [L,3], lights_i [L,3]; env_color [3].
    """

    def __init__(self, medium, lights_p, lights_i, env_color):
        self.medium = medium
        self.lights_p = lights_p
        self.lights_i = lights_i
        self.env_color = env_color

    def tree_flatten(self):
        return (self.medium, self.lights_p, self.lights_i, self.env_color), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @property
    def num_lights(self) -> int:
        return self.lights_p.shape[0]

    @property
    def is_gaussian(self) -> bool:
        return isinstance(self.medium, GaussianMixture)

    def with_medium(self, medium) -> "Scene":
        return Scene(medium, self.lights_p, self.lights_i, self.env_color)

    @staticmethod
    def create(medium, lights=(), env_color=DEFAULT_ENV_COLOR) -> "Scene":
        if lights:
            lp = jnp.asarray([l.position for l in lights], jnp.float32)
            li = jnp.asarray([l.intensity for l in lights], jnp.float32)
        else:
            lp = jnp.zeros((0, 3), jnp.float32)
            li = jnp.zeros((0, 3), jnp.float32)
        return Scene(medium, lp, li, jnp.asarray(env_color, jnp.float32))


# -----------------------------------------------------------------------------
# Text loaders
# -----------------------------------------------------------------------------

def _parse_lines(text: str):
    """Yield (tag, floats) per well-formed line; skip everything else."""
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag not in ("l", "g", "s"):
            continue
        # greedy float prefix, trailing junk ignored: matches the
        # reference's stream extraction (scene.h:89-115 reads exactly the
        # floats it needs) and the native sscanf parser for
        # whitespace-separated junk — 'g ... 0.8 # note' keeps its 11
        # floats on every backend.  (Tokens with a glued suffix like
        # '1;' still differ: Python drops them, sscanf reads the prefix.)
        vals = []
        for v in parts[1:]:
            try:
                vals.append(float(v))
            except ValueError:
                break
        yield tag, vals


def _read_text(path_or_text: Union[str, os.PathLike]) -> str:
    p = str(path_or_text)
    if os.path.exists(p):
        with open(p, "r") as f:
            return f.read()
    raise FileNotFoundError(f"Failed to open scene file: {p}")


def load_gmm(path: Union[str, os.PathLike],
             env_color=DEFAULT_ENV_COLOR) -> Scene:
    """Load a Gaussian scene (scene.h:72-120).  Uses the native C++ parser
    when built (gvr/native), with identical semantics."""
    native = _native_parse(path)
    if native is not None:
        g, _, l = native
        if len(g):
            lights = [Light(row[0:3], row[3:6]) for row in l]
            cov = np.empty((len(g), 3, 3), np.float32)
            cov[:, 0, 0] = g[:, 3]
            cov[:, 0, 1] = cov[:, 1, 0] = g[:, 4]
            cov[:, 0, 2] = cov[:, 2, 0] = g[:, 5]
            cov[:, 1, 1] = g[:, 6]
            cov[:, 1, 2] = cov[:, 2, 1] = g[:, 7]
            cov[:, 2, 2] = g[:, 8]
            gmm = GaussianMixture.from_covariances(
                g[:, 0:3], cov, g[:, 9], g[:, 10], g[:, 11:14])
            if gmm.n > 512:
                gmm = gmm.morton_sorted()
            return Scene.create(gmm, lights, env_color)
    return parse_gmm(_read_text(path), env_color)


def _native_parse(path):
    from gvr.native import loader as _nl
    lib = _nl.lib()
    if lib is None or not os.path.exists(str(path)):
        return None
    try:
        return lib.parse_scene(str(path))
    except Exception:
        return None


def parse_gmm(text: str, env_color=DEFAULT_ENV_COLOR) -> Scene:
    lights, means, covs, dens, albs, emis = [], [], [], [], [], []
    for tag, v in _parse_lines(text):
        if tag == "l" and len(v) >= 6:
            lights.append(Light(np.array(v[0:3], np.float32),
                                np.array(v[3:6], np.float32)))
        elif tag == "g" and len(v) >= 11:
            means.append(v[0:3])
            cxx, cxy, cxz, cyy, cyz, czz = v[3:9]
            covs.append([[cxx, cxy, cxz], [cxy, cyy, cyz], [cxz, cyz, czz]])
            dens.append(v[9])
            albs.append(v[10])
            emis.append(v[11:14] if len(v) >= 14 else [0.0, 0.0, 0.0])
    gmm = GaussianMixture.from_covariances(
        np.asarray(means, np.float32), np.asarray(covs, np.float32),
        np.asarray(dens, np.float32), np.asarray(albs, np.float32),
        np.asarray(emis, np.float32))
    if gmm.n > 512:
        # spatial locality for the big-N kernel's chunk culling; the
        # mixture itself is order-invariant
        gmm = gmm.morton_sorted()
    return Scene.create(gmm, lights, env_color)


def load_smm(path: Union[str, os.PathLike],
             env_color=DEFAULT_ENV_COLOR) -> Scene:
    """Load a sphere scene (scene.h:38-68)."""
    native = _native_parse(path)
    if native is not None:
        _, s, l = native
        if len(s):
            lights = [Light(row[0:3], row[3:6]) for row in l]
            smm = SphereMixture.create(s[:, 0:3], s[:, 3], s[:, 4], s[:, 5])
            return Scene.create(smm, lights, env_color)
    return parse_smm(_read_text(path), env_color)


def parse_smm(text: str, env_color=DEFAULT_ENV_COLOR) -> Scene:
    lights, cen, rad, sa, ss = [], [], [], [], []
    for tag, v in _parse_lines(text):
        if tag == "l" and len(v) >= 6:
            lights.append(Light(np.array(v[0:3], np.float32),
                                np.array(v[3:6], np.float32)))
        elif tag == "s" and len(v) >= 6:
            cen.append(v[0:3])
            rad.append(v[3])
            sa.append(v[4])
            ss.append(v[5])
    smm = SphereMixture.create(np.asarray(cen, np.float32),
                               np.asarray(rad, np.float32),
                               np.asarray(sa, np.float32),
                               np.asarray(ss, np.float32))
    return Scene.create(smm, lights, env_color)


def load_vdb(path: Union[str, os.PathLike]) -> Scene:
    """OpenVDB files: unimplemented, matching the reference's own stub
    (scene.h:21-22, 122, 144-145 — `VolumeType::VOXELS` / `load_VDB`).
    Unlike the reference, gvr DOES render voxel media — load a dense
    grid with ``gvr.scene.voxels.load_voxels`` (.npz) or bake one from
    a GaussianMixture with ``VoxelGrid.from_gaussians``."""
    raise NotImplementedError(
        "OpenVDB parsing not supported; convert to .npz (sigma_t [X,Y,Z]) "
        "and use gvr.scene.voxels.load_voxels")


def load_scene(path: Union[str, os.PathLike],
               env_color=None) -> Scene:
    """Auto-detect format: .npz is a voxel grid; a text scene with 'g'
    lines is a GMM, 's' lines SMM.  ``env_color=None`` means "use the
    file's env_color if it has one, else the reference default" — a None
    sentinel rather than a value compare, so a caller explicitly passing
    the default tuple keeps it, and array-valued env_colors don't hit
    numpy's ambiguous-truth-value error."""
    if str(path).endswith(".npz"):
        from gvr.scene.voxels import load_voxels
        return load_voxels(path, env_color)
    if env_color is None:
        env_color = DEFAULT_ENV_COLOR
    text = _read_text(path)
    tags = {tag for tag, _ in _parse_lines(text)}
    if "g" in tags:
        return parse_gmm(text, env_color)
    if "s" in tags:
        return parse_smm(text, env_color)
    raise ValueError(f"No primitives found in scene file: {path}")
