"""Host-side visualization (optional extra): a copy of
egohmr_tpu/viz/renderer.py, which is NumPy and PIL only.

Equivalent of reference utils/renderer.py:15-47 (pyrender EGL offscreen
overlay) and the open3d live viewers in the test scripts. This environment
has neither GL nor open3d, so:

  * when pyrender/trimesh ARE importable, the GL path uses them with the
    same camera setup as the reference;
  * otherwise `render_on_img` falls back to a dependency-free numpy
    software rasterizer (`render_mesh_soft`): perspective projection,
    per-face z-buffer, flat Lambertian shading with the reference's
    lighting setup (ambient 0.3 + camera-pose directional, double-sided),
    and the same valid-mask alpha composite as renderer.py:26-28 — a real
    mesh render, not a point splat;
  * a PIL point-splat (`_render_points_pil`) remains for vertex-only input
    (faces=None) and scene point clouds.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def project_vertices(
    vertices: np.ndarray, focal_length: Tuple[float, float],
    camera_center: Tuple[float, float],
) -> np.ndarray:
    """[V, 3] camera-frame vertices -> [V, 2] pixels."""
    z = np.clip(vertices[:, 2], 1e-6, None)
    u = vertices[:, 0] / z * focal_length[0] + camera_center[0]
    v = vertices[:, 1] / z * focal_length[1] + camera_center[1]
    return np.stack([u, v], axis=-1)


def render_on_img(
    img: np.ndarray,                  # [H, W, 3] uint8 RGB
    vertices: np.ndarray,             # [V, 3] camera-frame (transl applied)
    faces: Optional[np.ndarray],
    focal_length: Tuple[float, float],
    camera_center: Tuple[float, float],
    color=(10, 255, 255),
    alpha: float = 0.9,
    point_radius: int = 1,
) -> np.ndarray:
    """Overlay the posed body on the image (reference renderer.py:15-31)."""
    try:
        return _render_pyrender(img, vertices, faces, focal_length,
                                camera_center, color, alpha)
    except Exception:
        if faces is not None and len(faces):
            return render_mesh_soft(img, vertices, faces, focal_length,
                                    camera_center, color, alpha)
        return _render_points_pil(img, vertices, focal_length, camera_center,
                                  color, point_radius)


def render_mesh_soft(
    img: np.ndarray,                  # [H, W, 3] uint8 RGB
    vertices: np.ndarray,             # [V, 3] camera-frame (+z forward)
    faces: np.ndarray,                # [F, 3] int
    focal_length: Tuple[float, float],
    camera_center: Tuple[float, float],
    color=(10, 255, 255),
    alpha: float = 0.9,
    ambient: float = 0.3,
    near: float = 1e-3,
) -> np.ndarray:
    """Dependency-free z-buffered triangle rasterizer.

    Mirrors what the reference gets from pyrender (renderer.py:15-31):
    IntrinsicsCamera perspective projection, a directional light at the
    camera pose (headlight) over 0.3 ambient, flat shading, and the
    valid-mask alpha composite onto the input frame (renderer.py:26-28).
    Depth is perspective-correct (screen-linear 1/z); faces are shaded
    double-sided (|n·z|), so either winding convention renders. Faces with
    any vertex behind the near plane are dropped rather than clipped —
    fine for visualization, where the body sits well in front of the
    camera. `color` is one RGB for the mesh or per-face [F, 3].
    """
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    h, w = img.shape[:2]
    out = np.asarray(img, np.uint8).copy()

    colors = np.broadcast_to(
        np.asarray(color, np.float64), (len(f), 3))
    z = v[:, 2]
    keep = np.all(z[f] > near, axis=1)
    f, colors = f[keep], colors[keep]
    if len(f) == 0:
        return out

    uv = np.empty((len(v), 2))
    uv[:, 0] = v[:, 0] / np.clip(z, near, None) * focal_length[0] \
        + camera_center[0]
    uv[:, 1] = v[:, 1] / np.clip(z, near, None) * focal_length[1] \
        + camera_center[1]

    # flat shading: camera-frame face normal vs the camera's view axis
    # (reference adds a DirectionalLight at the camera pose over 0.3
    # ambient, renderer.py:19-21); double-sided like |cos|
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=1)
    ok = norm > 1e-12
    cos = np.zeros(len(f))
    cos[ok] = np.abs(n[ok, 2]) / norm[ok]
    shade = np.clip(ambient + (1.0 - ambient) * cos, 0.0, 1.0)
    face_rgb = shade[:, None] * colors

    tri = uv[f]                       # [F, 3, 2] screen-space corners
    tzinv = 1.0 / z[f]                # [F, 3] perspective-correct depth
    x0 = np.clip(np.floor(tri[..., 0].min(1)), 0, w - 1).astype(np.int64)
    x1 = np.clip(np.ceil(tri[..., 0].max(1)), 0, w - 1).astype(np.int64)
    y0 = np.clip(np.floor(tri[..., 1].min(1)), 0, h - 1).astype(np.int64)
    y1 = np.clip(np.ceil(tri[..., 1].max(1)), 0, h - 1).astype(np.int64)
    onscreen = (tri[..., 0].max(1) >= 0) & (tri[..., 0].min(1) < w) \
        & (tri[..., 1].max(1) >= 0) & (tri[..., 1].min(1) < h)

    zinv_buf = np.zeros((h, w))       # 0 == empty (1/z > 0 for visible)
    color_buf = np.zeros((h, w, 3))
    # far -> near keeps same-depth overdraw deterministic; the z-test
    # below is what makes the ordering correct, not the sort
    order = np.argsort(-z[f].mean(1))
    for i in order:
        if not onscreen[i]:
            continue
        (ax, ay), (bx, by), (cx, cy) = tri[i]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if abs(area) < 1e-12:
            continue
        xs = np.arange(x0[i], x1[i] + 1)
        ys = np.arange(y0[i], y1[i] + 1)
        px = xs[None, :] + 0.5        # pixel centers
        py = ys[:, None] + 0.5
        # signed edge functions -> barycentric weights
        wa = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        wb = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        wc = area - wa - wb
        inside = ((wa >= 0) & (wb >= 0) & (wc >= 0)) if area > 0 else \
            ((wa <= 0) & (wb <= 0) & (wc <= 0))
        if not inside.any():
            continue
        zinv = (wa * tzinv[i, 0] + wb * tzinv[i, 1] + wc * tzinv[i, 2]) / area
        region = zinv_buf[y0[i]:y1[i] + 1, x0[i]:x1[i] + 1]
        win = inside & (zinv > region)
        if not win.any():
            continue
        region[win] = zinv[win]
        color_buf[y0[i]:y1[i] + 1, x0[i]:x1[i] + 1][win] = face_rgb[i]

    covered = zinv_buf > 0
    blend = covered[..., None] * alpha
    out = (color_buf * blend + out * (1.0 - blend)).astype(np.uint8)
    return out


def render_in_scene(
    body_vertices: np.ndarray,        # [V, 3]
    faces: Optional[np.ndarray],
    scene_points: np.ndarray,         # [P, 3]
    view_transform: Optional[np.ndarray] = None,  # [4, 4] world->view
    img_size: Tuple[int, int] = (1920, 1080),
    focal_length: Tuple[float, float] = (1000.0, 1000.0),
) -> np.ndarray:
    """Body + scene point cloud from an external view
    (reference renderer.py:33-47 render_in_scene / open3d viewers).

    Without GL, the body mesh and the scene points (lifted to tiny
    camera-facing quads) go through ONE `render_mesh_soft` pass so they
    z-buffer against each other, like pyrender composing the body and
    static-scene meshes in one Scene (renderer.py:37-44) — the body is
    correctly occluded by scene geometry in front of it."""
    w, h = img_size
    cc = (w / 2.0, h / 2.0)
    if view_transform is not None:
        r, t = view_transform[:3, :3], view_transform[:3, 3]
        body_vertices = body_vertices @ r.T + t
        scene_points = scene_points @ r.T + t
    canvas = np.full((h, w, 3), 24, np.uint8)
    try:
        import pyrender  # noqa: F401 — probe before the splat work

        bg = _render_points_pil(canvas, scene_points, focal_length, cc,
                                (128, 128, 128), 1)
        return _render_pyrender(bg, body_vertices, faces, focal_length,
                                cc, (10, 255, 255), 0.9)
    except Exception:
        pass
    if faces is None or len(np.atleast_2d(faces)) == 0:
        canvas = _render_points_pil(canvas, scene_points, focal_length, cc,
                                    (128, 128, 128), 1)
        return render_on_img(canvas, body_vertices, None, focal_length, cc)
    body_vertices = np.asarray(body_vertices, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    qv, qf = _points_to_quads(np.asarray(scene_points, np.float64),
                              focal_length)
    verts = np.concatenate([body_vertices, qv])
    tris = np.concatenate([faces, qf + len(body_vertices)])
    colors = np.concatenate([
        np.broadcast_to([10.0, 255.0, 255.0], (len(faces), 3)),
        np.broadcast_to([128.0, 128.0, 128.0], (len(qf), 3))])
    return render_mesh_soft(canvas, verts, tris, focal_length, cc,
                            color=colors, alpha=0.9)


def _points_to_quads(points: np.ndarray, focal_length,
                     px_size: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """Lift a point cloud to camera-facing quads ~px_size pixels wide so
    points participate in the z-buffer (splats have no depth)."""
    z = np.clip(points[:, 2], 1e-3, None)
    half = px_size / float(min(focal_length)) * z * 0.5  # pixels -> metric
    offs = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                    np.float64)
    verts = (points[:, None, :] + half[:, None, None] * offs).reshape(-1, 3)
    base = np.arange(len(points))[:, None] * 4
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    tris = (base[:, None, :] + quad[None]).reshape(-1, 3)
    return verts, tris


def _render_pyrender(img, vertices, faces, focal_length, camera_center,
                     color, alpha):
    import pyrender
    import trimesh

    h, w = img.shape[:2]
    mesh = trimesh.Trimesh(vertices, faces, process=False)
    rot = trimesh.transformations.rotation_matrix(np.radians(180), [1, 0, 0])
    mesh.apply_transform(rot)
    material = pyrender.MetallicRoughnessMaterial(
        metallicFactor=0.0, alphaMode="OPAQUE",
        baseColorFactor=(color[0] / 255, color[1] / 255, color[2] / 255, 1.0))
    scene = pyrender.Scene(bg_color=[0, 0, 0, 0], ambient_light=(0.3,) * 3)
    scene.add(pyrender.Mesh.from_trimesh(mesh, material=material), "mesh")
    camera = pyrender.IntrinsicsCamera(
        fx=focal_length[0], fy=focal_length[1],
        cx=camera_center[0], cy=camera_center[1])
    scene.add(camera, pose=np.eye(4))
    light = pyrender.DirectionalLight(color=np.ones(3), intensity=3.0)
    scene.add(light, pose=np.eye(4))
    renderer = pyrender.OffscreenRenderer(viewport_width=w, viewport_height=h,
                                          point_size=1.0)
    rgba, _ = renderer.render(scene, flags=pyrender.RenderFlags.RGBA)
    renderer.delete()
    valid = (rgba[..., 3] > 0)[..., None]
    out = (rgba[..., :3] * valid * alpha
           + img * (1 - valid * alpha)).astype(np.uint8)
    return out


def _render_points_pil(img, vertices, focal_length, camera_center, color,
                       point_radius):
    from PIL import Image, ImageDraw

    h, w = img.shape[:2]
    uv = project_vertices(np.asarray(vertices), focal_length, camera_center)
    order = np.argsort(-np.asarray(vertices)[:, 2])  # far -> near
    im = Image.fromarray(np.asarray(img, np.uint8))
    draw = ImageDraw.Draw(im)
    r = point_radius
    for i in order:
        u, v = uv[i]
        if 0 <= u < w and 0 <= v < h:
            draw.ellipse((u - r, v - r, u + r, v + r), fill=tuple(color))
    return np.asarray(im)
