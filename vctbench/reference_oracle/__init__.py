"""The plain reference of the per-cone route (render_rays): see pipeline.py."""
