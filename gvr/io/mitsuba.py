"""Minimal Mitsuba 3 XML scene loader for the cross-validation subset.

The reference validates its sphere renders against Mitsuba's ``volpath``
using ``tests/env_one_sphere_test_ortho.xml`` (SURVEY §4.3).  This loader
covers exactly that schema family: orthographic/perspective sensor via
lookat, constant + point emitters, homogeneous media attached to sphere
shapes.  It returns (Scene, camera, width, height) ready to render with
``render_raymarch_spheres``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from gvr.scene.scene import Scene, Light, DEFAULT_ENV_COLOR
from gvr.scene.spheres import SphereMixture
from gvr.cameras import OrthographicCamera, PinholeCamera


def _rgb(val: str):
    parts = [float(v) for v in val.replace(",", " ").split()]
    if len(parts) == 1:
        parts = parts * 3
    return np.asarray(parts[:3], np.float32)


def load_mitsuba(path: str):
    """Parse the supported Mitsuba-XML subset -> (scene, camera, w, h)."""
    root = ET.parse(path).getroot()

    # sensor
    sensor = root.find("sensor")
    cam_type = sensor.get("type", "orthographic")
    lookat = sensor.find("./transform/lookat")
    origin = _rgb(lookat.get("origin"))
    target = _rgb(lookat.get("target"))
    film = sensor.find("film")
    w = h = 512
    for integer in film.findall("integer"):
        if integer.get("name") == "width":
            w = int(integer.get("value"))
        if integer.get("name") == "height":
            h = int(integer.get("value"))
    fov = 45.0
    for f in sensor.findall("float"):
        if f.get("name") == "fov":
            fov = float(f.get("value"))
    if cam_type == "orthographic":
        camera = OrthographicCamera.create(origin, target)
    else:
        camera = PinholeCamera.create(origin, target,
                                      float(np.deg2rad(fov)))

    # emitters
    env_color = np.asarray(DEFAULT_ENV_COLOR, np.float32)
    lights = []
    for em in root.findall("emitter"):
        if em.get("type") == "constant":
            env_color = _rgb(em.find("rgb").get("value"))
        elif em.get("type") == "point":
            pos = em.find("point")
            p = np.asarray([float(pos.get("x", 0)), float(pos.get("y", 0)),
                            float(pos.get("z", 0))], np.float32)
            inten = _rgb(em.find("rgb").get("value"))
            lights.append(Light(p, inten))

    # media by id: sigma_t * scale, albedo -> (sigma_a, sigma_s)
    media = {}
    for med in root.findall("medium"):
        albedo = np.float32(1.0)
        sigma_t = np.float32(1.0)
        scale = 1.0
        for rgb in med.findall("rgb"):
            if rgb.get("name") == "albedo":
                albedo = float(_rgb(rgb.get("value"))[0])
            if rgb.get("name") == "sigma_t":
                sigma_t = float(_rgb(rgb.get("value"))[0])
        for fl in med.findall("float"):
            if fl.get("name") == "scale":
                scale = float(fl.get("value"))
        st = sigma_t * scale
        media[med.get("id")] = (st * (1.0 - albedo), st * albedo)

    # sphere shapes with interior media
    centers, radii, sa, ss = [], [], [], []
    for shape in root.findall("shape"):
        if shape.get("type") != "sphere":
            continue
        pt = shape.find("point")
        c = [float(pt.get("x", 0)), float(pt.get("y", 0)),
             float(pt.get("z", 0))] if pt is not None else [0, 0, 0]
        radius = 1.0
        for fl in shape.findall("float"):
            if fl.get("name") == "radius":
                radius = float(fl.get("value"))
        ref = shape.find("ref")
        if ref is not None:
            med = media.get(ref.get("id"))
            if med is None:
                raise ValueError(
                    f"sphere references undefined medium id "
                    f"{ref.get('id')!r} (declared media: "
                    f"{sorted(media)})")
        else:
            med = (0.0, 1.0)
        centers.append(c)
        radii.append(radius)
        sa.append(med[0])
        ss.append(med[1])

    smm = SphereMixture.create(np.asarray(centers, np.float32),
                               np.asarray(radii, np.float32),
                               np.asarray(sa, np.float32),
                               np.asarray(ss, np.float32))
    scene = Scene.create(smm, lights, env_color)
    return scene, camera, w, h
