"""win32_raytracer_tpu — a path-tracing framework in JAX for NVIDIA GPUs.

A JAX/XLA/Pallas implementation of the capabilities of
jamesmcgill/win32-raytracer (Peter Shirley's *Ray Tracing in One Weekend*
on Win32/AVX): lambertian/metal/dielectric materials, antialiasing, defocus
blur, motion blur, the RTIOW test and final scenes, and tile-parallel
rendering — redesigned wavefront-first for accelerators.

Public surface::

    import win32_raytracer_tpu as wrt

    result = wrt.render("final", cfg=wrt.RenderConfig(width=1200, height=800,
                                                      samples=100))
    wrt.write_image("out.bmp", result.image)
"""

from .config import RenderConfig
from .api import AsyncRender, RenderResult, render, render_async
from .scene.builders import SCENES, get_scene, random_scene, test_scene
from .scene.camera import Camera, default_camera, make_camera
from .scene.spheres import SceneBuilder, SphereScene
from .io.image import write_image, read_bmp, read_image
from .core import materials
from .animation import orbit_path, render_animation
from .scene.composite import CompositeScene
from .scene.triangles import (TriangleScene, box_mesh, build_triangle_scene,
                              icosphere_mesh, load_obj)

__all__ = [
    "RenderConfig", "RenderResult", "AsyncRender", "render", "render_async",
    "SCENES", "get_scene", "random_scene", "test_scene",
    "Camera", "default_camera", "make_camera",
    "SceneBuilder", "SphereScene", "CompositeScene", "TriangleScene",
    "box_mesh", "build_triangle_scene", "icosphere_mesh", "load_obj",
    "orbit_path", "render_animation",
    "write_image", "read_bmp", "read_image", "materials",
]

__version__ = "0.2.0"
