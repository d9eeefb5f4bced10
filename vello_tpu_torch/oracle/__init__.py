from .renderer import OracleRenderer, render_scene
