"""Host-side rendering of bodies onto images."""
from .renderer import project_vertices, render_in_scene, render_mesh_soft, render_on_img

__all__ = ["project_vertices", "render_in_scene", "render_mesh_soft", "render_on_img"]
