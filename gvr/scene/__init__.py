from gvr.scene.gaussians import GaussianMixture
from gvr.scene.spheres import SphereMixture
from gvr.scene.voxels import VoxelGrid, load_voxels
from gvr.scene.scene import Scene, Light, load_scene, load_gmm, load_smm

__all__ = [
    "GaussianMixture",
    "SphereMixture",
    "VoxelGrid",
    "Scene",
    "Light",
    "load_scene",
    "load_gmm",
    "load_smm",
    "load_voxels",
]
